"""Packed masked set attention: the CUDA kernel's wrappers and plain versions.

Port of ``brepgen_tpu/kernels/attention.py:_packed_kernel`` (kernel K1) and
``_packed_flash_kernel`` (kernel K2): masked multi-head attention read
straight from the fused QKV projection [B, S, 3W] -> [B, S, W]; scale
1/sqrt(W/H); a key-padding bias of -1e9; f32 logits and softmax. K2 is K1's
function with K/V streamed in chunks under an online softmax; the TPU needed
it only because full-S K/V did not fit VMEM. ``csrc/packed_attention.cu``
already streams K/V in 64-key shared-memory tiles with a running max and
normaliser, at any S, so both entries launch that one kernel, each with its
own launch count. The transformer picks the entry by length
(``nn/transformer.py:attention_route``).
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
from typing import Optional

import torch

from brepgen_tpu_torch.kernels import LAUNCH_COUNTS
from brepgen_tpu_torch.kernels import _build

NEG_INF = -1e9
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64)

# Largest full-S K (or V) column block, in bytes of the compute type, that
# the JAX package keeps resident in the packed kernel's VMEM
# (``brepgen_tpu/kernels/attention.py:PACKED_RESIDENT_BYTES``); the
# transformer's length routing reads it at call time. Override per
# deployment with BREPGEN_PACKED_RESIDENT_MB.
PACKED_RESIDENT_BYTES = int(os.environ.get("BREPGEN_PACKED_RESIDENT_MB", "8")) * 1024 * 1024
FLASH_BLOCK_K = 2048  # keys per chunk of K2's plain version, as K2's block_k


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


def packed_flash_attention_reference(
    qkv: torch.Tensor, num_heads: int, key_padding_mask: Optional[torch.Tensor] = None,
    block_k: int = FLASH_BLOCK_K,
) -> torch.Tensor:
    """Plain PyTorch version of K2: K/V in ``block_k``-key chunks under an
    online softmax (running max, normaliser and accumulator in f32), so no
    [B, H, S, S] tensor is held.

    Counterpart of ``_packed_flash_forward``; equal to
    ``packed_attention_reference`` up to summation order. A query row whose
    keys are all masked gets the uniform mean of V over the S real keys.
    """
    B, S, W3 = qkv.shape
    W = W3 // 3
    D = W // num_heads
    q, k, v = (a.reshape(B, S, num_heads, D).transpose(1, 2).float()
               for a in qkv.split(W, dim=-1))
    bias = torch.zeros((B, S), dtype=torch.float32, device=qkv.device)
    if key_padding_mask is not None:
        bias = torch.where(key_padding_mask, NEG_INF, 0.0).float()
    scale = 1.0 / math.sqrt(D)
    m = torch.full((B, num_heads, S, 1), -1e30, device=qkv.device)
    l = torch.zeros((B, num_heads, S, 1), device=qkv.device)
    acc = torch.zeros((B, num_heads, S, D), device=qkv.device)
    for k0 in range(0, S, block_k):
        s = (torch.einsum("bhqd,bhkd->bhqk", q, k[:, :, k0:k0 + block_k]) * scale
             + bias[:, None, None, k0:k0 + block_k])
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p, v[:, :, k0:k0 + block_k])
        m = m_new
    return (acc / l).to(qkv.dtype).transpose(1, 2).reshape(B, S, W)


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


def _launch(name: str, qkv: torch.Tensor, num_heads: int,
            key_padding_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Check the input, launch ``packed_attention.cu`` and count the launch
    under ``name``."""
    if qkv.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {qkv.device}")
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"{name}: qkv must be [B, S, 3W], got {tuple(qkv.shape)}")
    B, S, W3 = qkv.shape
    W = W3 // 3
    if W % num_heads or W // num_heads not in _HEAD_DIMS:
        raise ValueError(f"{name}: head width W/H must be one of {_HEAD_DIMS}, "
                         f"got W={W}, H={num_heads}")
    if qkv.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype must be float32 or bfloat16, got {qkv.dtype}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError(f"{name}: qkv must be contiguous and 16-byte aligned")
    if key_padding_mask is None:
        mask = torch.zeros((B, S), dtype=torch.uint8, device=qkv.device)
    else:
        if key_padding_mask.shape != (B, S) or key_padding_mask.dtype != torch.bool:
            raise ValueError(f"{name}: key_padding_mask must be bool [B, S]")
        if key_padding_mask.device != qkv.device:
            raise ValueError(f"{name}: key_padding_mask is on another device")
        mask = key_padding_mask.contiguous().view(torch.uint8)
    out = torch.empty((B, S, W), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        rc = _library().packed_attention_forward(
            qkv.data_ptr(), mask.data_ptr(), out.data_ptr(), B, S, W, num_heads,
            _DTYPES[qkv.dtype], 1.0 / math.sqrt(W // num_heads),  # rounded to f32 by ctypes
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")
    LAUNCH_COUNTS[name] += 1
    return out


def packed_attention(
    qkv: torch.Tensor, num_heads: int, key_padding_mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """K1: [B, S, 3W] -> [B, S, W] through the CUDA kernel.

    A tensor on the CPU takes the plain version; a CUDA tensor launches the
    kernel or raises.
    """
    if qkv.device.type == "cpu":
        return packed_attention_reference(qkv, num_heads, key_padding_mask)
    return _launch("packed_attention", qkv, num_heads, key_padding_mask)


def packed_flash_attention(
    qkv: torch.Tensor, num_heads: int, key_padding_mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """K2, the long-set entry: [B, S, 3W] -> [B, S, W] through the same
    streaming CUDA kernel as K1 (its grid, 64-bit offsets and shared memory do
    not depend on S).

    A tensor on the CPU takes K2's plain version; a CUDA tensor launches the
    kernel or raises.
    """
    if qkv.device.type == "cpu":
        return packed_flash_attention_reference(qkv, num_heads, key_padding_mask)
    return _launch("packed_flash_attention", qkv, num_heads, key_padding_mask)
