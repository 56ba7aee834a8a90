"""Masked set attention per (batch, head): the CUDA kernel's wrapper and its
plain version.

Port of ``brepgen_tpu/kernels/attention.py:_attn_kernel`` (kernel K3): the
same masked attention as the packed kernel, on split heads q, k, v
[B, H, S, D] -> [B, H, S, D]; scale 1/sqrt(D) of the true D; a key-padding
bias of -1e9; f32 logits, softmax and accumulator. The transformer routes the
mid-range set lengths here (``nn/transformer.py:attention_route``). The
kernel is ``csrc/set_attention.cu``: f32 on ``mma.sync`` through 3xTF32,
bf16 on K1's ``wgmma`` + TMA kernel body fed by tensor maps over the split
heads. With grad enabled the backward
recomputes through the plain version under autograd, as JAX's ``_bwd``
recomputes through XLA.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from brepgen_tpu_torch.kernels import LAUNCH_COUNTS
from brepgen_tpu_torch.kernels import _build
from brepgen_tpu_torch.kernels import attention as _attention
from brepgen_tpu_torch.kernels.attention import _DTYPES, _HEAD_DIMS, NEG_INF, recompute_grads


def set_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: einsum, softmax in f32, einsum.

    Counterpart of ``_xla_attention``: ``key_padding_mask`` [B, S] is True at
    padding.
    """
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * (1.0 / math.sqrt(q.shape[-1]))
    if key_padding_mask is not None:
        bias = torch.where(key_padding_mask[:, None, None, :], NEG_INF, 0.0)
        logits = logits + bias.to(logits.dtype)
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("set_attention")
    fn = lib.set_attention_forward
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib


class SetAttentionFn(torch.autograd.Function):
    """K3 forward; backward recomputed through the plain version."""

    @staticmethod
    def forward(ctx, q, k, v, key_padding_mask):
        ctx.save_for_backward(q, k, v, key_padding_mask)
        return _forward(q, k, v, key_padding_mask)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, mask = ctx.saved_tensors
        return (*recompute_grads(set_attention_reference, [q, k, v], dout, mask), None)


def set_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, H, S, D] x 3 -> [B, H, S, D] through the CUDA kernel; with grad
    enabled its backward recomputes through the plain version.

    A tensor on the CPU takes the plain version; a CUDA tensor launches the
    kernel or raises.
    """
    if torch.is_grad_enabled():
        return SetAttentionFn.apply(q, k, v, key_padding_mask)
    return _forward(q, k, v, key_padding_mask)


def _forward(q, k, v, key_padding_mask):
    """K3 without autograd: the kernel on the card, the plain version on the
    CPU."""
    if not _attention._on_card(q):
        return set_attention_reference(q, k, v, key_padding_mask)
    return _launch(q, k, v, key_padding_mask)


def _launch(q, k, v, key_padding_mask):
    """Check the input, launch ``set_attention.cu`` and count the launch."""
    if q.device.type != "cuda":
        raise ValueError(f"set_attention: unsupported device {q.device}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"set_attention: q, k, v must be one [B, H, S, D] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, S, D = q.shape
    if D not in _HEAD_DIMS:
        raise ValueError(f"set_attention: head width D must be one of {_HEAD_DIMS}, got {D}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"set_attention: q, k, v must all be float32 or all bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    for a in (k, v):
        if a.device != q.device:
            raise ValueError("set_attention: q, k, v lie on different devices")
    for a in (q, k, v):
        if not a.is_contiguous() or a.data_ptr() % 16:
            raise ValueError("set_attention: q, k, v must be contiguous and 16-byte aligned")
    if key_padding_mask is None:
        mask = torch.zeros((B, S), dtype=torch.uint8, device=q.device)
    else:
        if key_padding_mask.shape != (B, S) or key_padding_mask.dtype != torch.bool:
            raise ValueError("set_attention: key_padding_mask must be bool [B, S]")
        if key_padding_mask.device != q.device:
            raise ValueError("set_attention: key_padding_mask is on another device")
        mask = key_padding_mask.contiguous().view(torch.uint8)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = _library().set_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
            B, H, S, D, _DTYPES[q.dtype], 1.0 / math.sqrt(D),  # rounded to f32 by ctypes
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"set_attention: kernel launch failed with CUDA error {rc}")
    LAUNCH_COUNTS["set_attention"] += 1
    return out
