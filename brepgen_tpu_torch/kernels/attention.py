"""Packed masked set attention: the CUDA kernel's wrapper and its plain version.

Port of ``brepgen_tpu/kernels/attention.py:_packed_kernel`` (kernel K1): masked
multi-head attention read straight from the fused QKV projection
[B, S, 3W] -> [B, S, W]; scale 1/sqrt(W/H); a key-padding bias of -1e9; f32
logits and softmax. The kernel is ``csrc/packed_attention.cu``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from brepgen_tpu_torch.kernels import LAUNCH_COUNTS
from brepgen_tpu_torch.kernels import _build

NEG_INF = -1e9
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64)


def packed_attention_reference(
    qkv: torch.Tensor, num_heads: int, key_padding_mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Plain PyTorch version: split, einsum, softmax in f32, einsum.

    Counterpart of ``_packed_reference`` (and of the transformer's plain
    ``masked_attention_xla``): ``key_padding_mask`` [B, S] is True at padding.
    """
    B, S, W3 = qkv.shape
    W = W3 // 3
    D = W // num_heads
    q, k, v = (a.reshape(B, S, num_heads, D).transpose(1, 2) for a in qkv.split(W, dim=-1))
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * (1.0 / math.sqrt(D))
    if key_padding_mask is not None:
        bias = torch.where(key_padding_mask[:, None, None, :], NEG_INF, 0.0)
        logits = logits + bias.to(logits.dtype)
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v)
    return out.transpose(1, 2).reshape(B, S, W)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("packed_attention")
    fn = lib.packed_attention_forward
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib


def packed_attention(
    qkv: torch.Tensor, num_heads: int, key_padding_mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """[B, S, 3W] -> [B, S, W] through the CUDA kernel.

    A tensor on the CPU takes the plain version; a CUDA tensor launches the
    kernel or raises.
    """
    if qkv.device.type == "cpu":
        return packed_attention_reference(qkv, num_heads, key_padding_mask)
    if qkv.device.type != "cuda":
        raise ValueError(f"packed_attention: unsupported device {qkv.device}")
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"packed_attention: qkv must be [B, S, 3W], got {tuple(qkv.shape)}")
    B, S, W3 = qkv.shape
    W = W3 // 3
    if W % num_heads or W // num_heads not in _HEAD_DIMS:
        raise ValueError(f"packed_attention: head width W/H must be one of {_HEAD_DIMS}, "
                         f"got W={W}, H={num_heads}")
    if qkv.dtype not in _DTYPES:
        raise TypeError(f"packed_attention: dtype must be float32 or bfloat16, got {qkv.dtype}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("packed_attention: qkv must be contiguous and 16-byte aligned")
    if key_padding_mask is None:
        mask = torch.zeros((B, S), dtype=torch.uint8, device=qkv.device)
    else:
        if key_padding_mask.shape != (B, S) or key_padding_mask.dtype != torch.bool:
            raise ValueError("packed_attention: key_padding_mask must be bool [B, S]")
        if key_padding_mask.device != qkv.device:
            raise ValueError("packed_attention: key_padding_mask is on another device")
        mask = key_padding_mask.contiguous().view(torch.uint8)
    out = torch.empty((B, S, W), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        rc = _library().packed_attention_forward(
            qkv.data_ptr(), mask.data_ptr(), out.data_ptr(), B, S, W, num_heads,
            _DTYPES[qkv.dtype], 1.0 / math.sqrt(W // num_heads),  # rounded to f32 by ctypes
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"packed_attention: kernel launch failed with CUDA error {rc}")
    LAUNCH_COUNTS["packed_attention"] += 1
    return out
