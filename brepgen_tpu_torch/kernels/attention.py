"""Packed masked set attention: the CUDA kernel's wrappers and plain versions.

Port of ``brepgen_tpu/kernels/attention.py:_packed_kernel`` (kernel K1) and
``_packed_flash_kernel`` (kernel K2): masked multi-head attention read
straight from the fused QKV projection [B, S, 3W] -> [B, S, W]; scale
1/sqrt(W/H); a key-padding bias of -1e9; f32 logits and softmax. K2 is K1's
function with K/V streamed in chunks under an online softmax; the TPU needed
it only because full-S K/V did not fit VMEM. ``csrc/packed_attention.cu``
streams K/V in 64-key shared-memory tiles with a running max and normaliser,
at any S, on the tensor cores (f32: ``mma.sync`` through 3xTF32, K3's
forward on the packed layout; bf16: ``wgmma`` with TMA), so both entries
launch that one kernel, each with its own launch count. The transformer
picks the entry by length (``nn/transformer.py:attention_route``).

Kernel K5, ``_packed_bwd_kernel``, is the backward of K1:
``csrc/packed_attention_bwd.cu``, launched by ``packed_attention_backward``.
Every entry is differentiable: ``packed_attention`` runs under an autograd
function whose forward is K1 and whose backward is K5; the long-set entry
recomputes its backward through the plain version under autograd, as JAX's
``_packed_bwd`` does (training never reaches those lengths). Under autograd
K1 also writes its training residuals (``packed_attention_with_stats``):
each row's max m and 1/l, f32 [B, H, S, 2], from which K5 forms P without
recomputing the softmax, and in bf16 its output before rounding, f32
[B, S, W], from which K5 takes Delta = rowsum(dO o O) (B*S*W*4 bytes a
layer: 236 MB at the edgez training shape).
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
_HEAD_DIMS = (16, 32, 64)

# Largest full-S K (or V) column block, in bytes of the compute type, that
# the JAX package keeps resident in the packed kernel's VMEM
# (``brepgen_tpu/kernels/attention.py:PACKED_RESIDENT_BYTES``); the
# transformer's length routing reads it at call time. Override per
# deployment with BREPGEN_PACKED_RESIDENT_MB.
PACKED_RESIDENT_BYTES = int(os.environ.get("BREPGEN_PACKED_RESIDENT_MB", "8")) * 1024 * 1024
FLASH_BLOCK_K = 2048  # keys per chunk of K2's plain version, as K2's block_k


def packed_attention_reference(
    qkv: torch.Tensor, num_heads: int, key_padding_mask: Optional[torch.Tensor] = None,
    with_stats: bool = False,
):
    """Plain PyTorch version: split, einsum, softmax in f32, einsum.

    Counterpart of ``_packed_reference`` (and of the transformer's plain
    ``masked_attention_xla``): ``key_padding_mask`` [B, S] is True at padding.
    ``with_stats`` returns ``(out, m, inv_l)`` instead, with each row's max
    logit m and 1/sum_j exp(l_ij - m), f32 [B, H, S], from logits formed in
    f32 as the kernel forms them (K1's training residuals): P = exp(l - m) *
    inv_l. They stay apart: for a fully masked row every logit is -1e9, and
    -1e9 + log S rounds back to -1e9 in f32.
    """
    B, S, W3 = qkv.shape
    W = W3 // 3
    D = W // num_heads
    q, k, v = (a.reshape(B, S, num_heads, D).transpose(1, 2) for a in qkv.split(W, dim=-1))
    bias = None
    if key_padding_mask is not None:
        bias = torch.where(key_padding_mask[:, None, None, :], NEG_INF, 0.0)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * (1.0 / math.sqrt(D))
    if bias is not None:
        logits = logits + bias.to(logits.dtype)
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v).transpose(1, 2).reshape(B, S, W)
    if not with_stats:
        return out
    if q.dtype != torch.float32:
        logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (1.0 / math.sqrt(D))
        if bias is not None:
            logits = logits + bias
    m = logits.amax(dim=-1)
    inv_l = 1.0 / torch.exp(logits - m[..., None]).sum(dim=-1)
    return out, m, inv_l


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


def packed_attention_backward_reference(
    qkv: torch.Tensor, dout: torch.Tensor, num_heads: int,
    key_padding_mask: Optional[torch.Tensor] = None, sums_in_f64: bool = False,
    stats: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of K5: the gradient of ``packed_attention``,
    [B, S, 3W] x dO [B, S, W] -> dqkv [B, S, 3W], step by step in f32 and
    returned in the input type.

    With P = softmax(s QK^T + bias): dV = P^T dO, dP = dO V^T,
    dL = P o (dP - rowsum(dP o P)), dQ = s dL K, dK = s dL^T Q, as
    ``_packed_bwd_kernel`` computes them. ``stats`` [B, H, S, 2], the
    forward's (m, 1/l) (``packed_attention_with_stats``), gives P =
    exp(l - m) * (1/l) instead of the softmax, as the kernel takes it.
    ``sums_in_f64`` keeps the logits in f32 (scale, then the bias, so a
    fully masked row stays uniform) and takes the softmax and every sum
    after them in f64, returned in f64: the gradient with no rounding of its
    own over S rows, beside which the f32 version's drift is read.
    """
    B, S, W3 = qkv.shape
    W = W3 // 3
    D = W // num_heads
    split = lambda a: a.reshape(B, S, num_heads, D).transpose(1, 2).float()  # noqa: E731
    q, k, v = (split(a) for a in qkv.split(W, dim=-1))
    g = split(dout)
    scale = 1.0 / math.sqrt(D)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if key_padding_mask is not None:
        logits = logits + torch.where(key_padding_mask[:, None, None, :], NEG_INF, 0.0)
    if sums_in_f64:
        logits, q, k, v, g = (a.double() for a in (logits, q, k, v, g))
    if stats is not None:
        p = torch.exp(logits - stats[..., :1].to(logits.dtype)) * stats[..., 1:].to(logits.dtype)
    else:
        p = torch.softmax(logits, dim=-1)
    del logits
    dv = torch.einsum("bhqk,bhqd->bhkd", p, g)
    dp = torch.einsum("bhqd,bhkd->bhqk", g, v)
    dl = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bhqk,bhkd->bhqd", dl, k) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", dl, q) * scale
    merge = lambda a: a.transpose(1, 2).reshape(B, S, W)  # noqa: E731
    dqkv = torch.cat([merge(dq), merge(dk), merge(dv)], dim=-1)
    return dqkv if sums_in_f64 else dqkv.to(qkv.dtype)


def _on_card(t: torch.Tensor) -> bool:
    """Whether an entry launches its kernel for ``t`` (else the plain
    version runs: a CPU tensor)."""
    return t.device.type != "cpu"


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("packed_attention")
    fn = lib.packed_attention_forward
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib


@functools.cache
def _backward_library() -> ctypes.CDLL:
    lib = _build.load("packed_attention_bwd")
    fn = lib.packed_attention_backward
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib


def _check(name: str, qkv: torch.Tensor, num_heads: int,
           key_padding_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Check what the kernels take; returns the mask as uint8 [B, S]."""
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
    return mask


def _launch(name: str, qkv: torch.Tensor, num_heads: int,
            key_padding_mask: Optional[torch.Tensor], residuals: bool = False):
    """Check the input, launch ``packed_attention.cu`` and count the launch
    under ``name``. ``residuals`` also has it write the training residuals
    and returns ``(out, o32, stats)`` (see ``packed_attention_with_stats``)."""
    mask = _check(name, qkv, num_heads, key_padding_mask)
    B, S, W3 = qkv.shape
    W = W3 // 3
    out = torch.empty((B, S, W), dtype=qkv.dtype, device=qkv.device)
    o32 = stats = None
    if residuals:
        stats = torch.empty((B, num_heads, S, 2), dtype=torch.float32, device=qkv.device)
        o32 = out if qkv.dtype == torch.float32 else torch.empty(
            (B, S, W), dtype=torch.float32, device=qkv.device)
    with torch.cuda.device(qkv.device):
        rc = _library().packed_attention_forward(
            qkv.data_ptr(), mask.data_ptr(), out.data_ptr(),
            o32.data_ptr() if o32 is not None and o32 is not out else None,
            stats.data_ptr() if stats is not None else None, B, S, W, num_heads,
            _DTYPES[qkv.dtype], 1.0 / math.sqrt(W // num_heads),  # rounded to f32 by ctypes
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")
    LAUNCH_COUNTS[name] += 1
    return (out, o32, stats) if residuals else out


def packed_attention_with_stats(
    qkv: torch.Tensor, num_heads: int, key_padding_mask: Optional[torch.Tensor] = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1 as training runs it, without autograd: ``(out, o32, stats)``, the
    output [B, S, W] in the input type, the same output in f32 before its
    rounding (``out`` itself in f32) and each row's max and 1/sum f32
    [B, H, S, 2], the residuals ``packed_attention_backward`` takes. One
    launch, counted under ``packed_attention``; ``out`` is bit-equal to
    ``packed_attention``'s.

    A tensor on the CPU takes the plain version (``with_stats``; its
    ``o32`` is ``out`` in f32, which the plain backward does not read); a
    CUDA tensor launches the kernel or raises.
    """
    if _on_card(qkv):
        return _launch("packed_attention", qkv, num_heads, key_padding_mask, residuals=True)
    out, m, inv_l = packed_attention_reference(qkv, num_heads, key_padding_mask, with_stats=True)
    return out, out.float(), torch.stack([m, inv_l], dim=-1)


def packed_attention_backward(
    qkv: torch.Tensor, dout: torch.Tensor, num_heads: int,
    key_padding_mask: Optional[torch.Tensor] = None, *, out: torch.Tensor,
    stats: torch.Tensor,
) -> torch.Tensor:
    """K5: the gradient dqkv [B, S, 3W] of ``packed_attention`` at ``qkv``
    for the output gradient ``dout`` [B, S, W], through the CUDA kernel
    (two launches, counted as one call), given the forward's residuals from
    ``packed_attention_with_stats``: ``out`` its output in f32 [B, S, W]
    (rowsum(dP o P) is taken as rowsum(dO o out)) and ``stats`` its rows'
    (m, 1/l) [B, H, S, 2] (P = exp(l - m) * (1/l)). The plain version takes
    P from ``stats`` too and does not read ``out``.

    A tensor on the CPU takes the plain version; a CUDA tensor launches the
    kernel or raises.
    """
    if not _on_card(qkv):
        return packed_attention_backward_reference(qkv, dout, num_heads, key_padding_mask,
                                                   stats=stats)
    return _launch_backward(qkv, dout, num_heads, key_padding_mask, out, stats)


def _launch_backward(qkv: torch.Tensor, dout: torch.Tensor, num_heads: int,
                     key_padding_mask: Optional[torch.Tensor], out: torch.Tensor,
                     stats: torch.Tensor) -> torch.Tensor:
    """Check the input, launch ``packed_attention_bwd.cu`` and count it."""
    name = "packed_attention_backward"
    mask = _check(name, qkv, num_heads, key_padding_mask)
    B, S, W3 = qkv.shape
    W = W3 // 3
    for label, t, shape, dtype in (("dout", dout, (B, S, W), qkv.dtype),
                                   ("out", out, (B, S, W), torch.float32),
                                   ("stats", stats, (B, num_heads, S, 2), torch.float32)):
        if t.shape != shape or t.dtype != dtype or t.device != qkv.device:
            raise ValueError(f"{name}: {label} must be {shape} of {dtype} on {qkv.device}, "
                             f"got {tuple(t.shape)} of {t.dtype} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {label} must be contiguous and 16-byte aligned")
    rows = torch.empty((B, num_heads, S, 4), dtype=torch.float32, device=qkv.device)
    dqkv = torch.empty_like(qkv)
    with torch.cuda.device(qkv.device):
        rc = _backward_library().packed_attention_backward(
            qkv.data_ptr(), dout.data_ptr(), out.data_ptr(), stats.data_ptr(),
            mask.data_ptr(), rows.data_ptr(),
            dqkv.data_ptr(), B, S, W, num_heads, _DTYPES[qkv.dtype],
            1.0 / math.sqrt(W // num_heads), torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")
    LAUNCH_COUNTS[name] += 1
    return dqkv


def _forward(name: str, qkv: torch.Tensor, num_heads: int,
             key_padding_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The entry ``name`` without autograd: its kernel on the card, its plain
    version on the CPU."""
    if _on_card(qkv):
        return _launch(name, qkv, num_heads, key_padding_mask)
    plain = (packed_attention_reference if name == "packed_attention"
             else packed_flash_attention_reference)
    return plain(qkv, num_heads, key_padding_mask)


def recompute_grads(fn, inputs, dout: torch.Tensor, *args):
    """Gradients of ``fn(*inputs, *args)`` for ``dout``, recomputed through
    ``fn`` under autograd (the backward of the entries whose TPU kernels
    had none: ``_bwd`` and ``_packed_bwd``'s long-set branch in JAX)."""
    with torch.enable_grad():
        xs = [x.detach().requires_grad_() for x in inputs]
        return torch.autograd.grad(fn(*xs, *args), xs, dout)


class PackedAttentionFn(torch.autograd.Function):
    """K1 forward, K5 backward (given the forward's residuals: its output in
    f32 and its rows' max and 1/sum)."""

    @staticmethod
    def forward(ctx, qkv, num_heads, key_padding_mask):
        ctx.num_heads = num_heads
        out, o32, stats = packed_attention_with_stats(qkv, num_heads, key_padding_mask)
        ctx.save_for_backward(qkv, key_padding_mask, o32, stats)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, mask, o32, stats = ctx.saved_tensors
        dqkv = packed_attention_backward(qkv, dout.contiguous(), ctx.num_heads, mask, out=o32,
                                         stats=stats)
        return dqkv, None, None


class PackedFlashAttentionFn(torch.autograd.Function):
    """K2 forward; backward recomputed through the plain version."""

    @staticmethod
    def forward(ctx, qkv, num_heads, key_padding_mask):
        ctx.num_heads = num_heads
        ctx.save_for_backward(qkv, key_padding_mask)
        return _forward("packed_flash_attention", qkv, num_heads, key_padding_mask)

    @staticmethod
    def backward(ctx, dout):
        qkv, mask = ctx.saved_tensors
        (dqkv,) = recompute_grads(packed_attention_reference, [qkv], dout, ctx.num_heads, mask)
        return dqkv, None, None


def packed_attention(
    qkv: torch.Tensor, num_heads: int, key_padding_mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """K1: [B, S, 3W] -> [B, S, W] through the CUDA kernel; with grad
    enabled its backward is K5.

    A tensor on the CPU takes the plain versions; a CUDA tensor launches the
    kernels or raises.
    """
    if torch.is_grad_enabled():
        return PackedAttentionFn.apply(qkv, num_heads, key_padding_mask)
    return _forward("packed_attention", qkv, num_heads, key_padding_mask)


def packed_flash_attention(
    qkv: torch.Tensor, num_heads: int, key_padding_mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """K2, the long-set entry: [B, S, 3W] -> [B, S, W] through the same
    streaming CUDA kernel as K1 (its grid, 64-bit offsets and shared memory do
    not depend on S). With grad enabled its backward recomputes through the
    plain version.

    A tensor on the CPU takes K2's plain version; a CUDA tensor launches the
    kernel or raises.
    """
    if torch.is_grad_enabled():
        return PackedFlashAttentionFn.apply(qkv, num_heads, key_padding_mask)
    return _forward("packed_flash_attention", qkv, num_heads, key_padding_mask)
