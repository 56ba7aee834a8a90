"""Multi-head attention over short token sets at head width 32: the CUDA
kernel's wrapper, its plain version and the rule that picks it.

The edge VAE's self-attention (``nn/vae1d.py:SelfAttention1D``) runs at
L = 4 tokens, 16 heads of width 32, in its mid blocks: the VAE takes 32
points an edge and downsamples three times. The kernel,
``csrc/vae_attention.cu``, takes q, k, v straight from the three linears,
[N, L, C] with C = H * 32, and writes the output in the same layout for the
output projection: scores, an f32 softmax with scale 1/sqrt(32) and the
product with V in one pass over the bytes, with no head split or merge. It
has no backward: ``takes_kernel`` sends it only calls that need no gradient
on a CUDA card (the frozen encodes of training, the cascade's decode,
validation) and at most ``MAX_LEN`` tokens; every other call keeps the
module's einsums. The JAX package
has no TPU kernel here.
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
from brepgen_tpu_torch.kernels.attention import _DTYPES

HEAD_DIM = 32
MAX_LEN = 4  # csrc/vae_attention.cu:kMaxLen


def vae_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            num_heads: int) -> torch.Tensor:
    """Plain PyTorch version, as the kernel computes: [N, L, C] x 3 ->
    [N, L, C], heads of width C / num_heads, logits, softmax and products in
    f32, rounded once to the input type."""
    N, L, C = q.shape
    D = C // num_heads
    qh, kh, vh = (a.float().reshape(N, L, num_heads, D) for a in (q, k, v))
    probs = torch.softmax(torch.einsum("nihd,njhd->nhij", qh, kh) * (1.0 / math.sqrt(D)), dim=-1)
    return torch.einsum("nhij,njhd->nihd", probs, vh).reshape(N, L, C).to(q.dtype)


def takes_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int) -> bool:
    """Whether ``SelfAttention1D`` hands q, k, v [N, L, C] to the kernel: on
    a CUDA card, with no gradient to take, at head width 32, for at most
    ``MAX_LEN`` tokens, all three f32 or all bf16, contiguous."""
    return _attention._on_card(q) and _refusal(q, k, v, num_heads) is None


def _refusal(q, k, v, num_heads) -> Optional[Exception]:
    """Why the kernel cannot take q, k, v (their device aside), or None."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return RuntimeError("vae_attention: forward only; it has no backward (call it under "
                            "torch.no_grad() or on detached inputs)")
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        return ValueError(f"vae_attention: q, k, v must be one [N, L, C] shape, got "
                          f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    _, L, C = q.shape
    if C != HEAD_DIM * num_heads:
        return ValueError(f"vae_attention: C = {C} is not {num_heads} heads of width {HEAD_DIM}")
    if not 1 <= L <= MAX_LEN:
        return ValueError(f"vae_attention: L must be in [1, {MAX_LEN}], got {L}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        return TypeError(f"vae_attention: q, k, v must all be float32 or all bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not all(a.is_contiguous() and a.data_ptr() % 16 == 0 for a in (q, k, v)):
        return ValueError("vae_attention: q, k, v must be contiguous and 16-byte aligned")
    return None


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("vae_attention")
    fn = lib.vae_attention_forward
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib


def vae_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  num_heads: int) -> torch.Tensor:
    """[N, L, C] x 3 -> [N, L, C] through the CUDA kernel, one launch on the
    current stream (capturable into a CUDA graph; none for N = 0). Forward
    only: an input that requires grad raises, as does one the kernel does not
    take."""
    refusal = _refusal(q, k, v, num_heads)
    if refusal is not None:
        raise refusal
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"vae_attention: q, k, v must lie on one CUDA device, got {q.device}, "
                         f"{k.device}, {v.device}")
    out = torch.empty_like(q)
    N, L, _ = q.shape
    if N == 0:
        return out
    with torch.cuda.device(q.device):
        rc = _library().vae_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), N, L, num_heads,
            _DTYPES[q.dtype], 1.0 / math.sqrt(HEAD_DIM),  # rounded to f32 by ctypes
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"vae_attention: kernel launch failed with CUDA error {rc}")
    LAUNCH_COUNTS["vae_attention"] += 1
    return out
