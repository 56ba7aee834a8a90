"""Residual add, LayerNorm and its casts in one pass: the CUDA kernel's
wrapper, its plain version and the rule that picks it.

The denoisers' norms (``nn/layers.py:LayerNorm``) compute in f32 whatever
the compute type: in bf16 the plain path is a residual add, a cast of the
sum to f32, ``F.layer_norm`` and a cast back, each a pass over the token
rows. The kernel, ``csrc/add_layer_norm.cu``, takes x [..., W], the pending
residual ``delta`` (or none) and the f32 weight and bias, and writes the sum
s = x + delta, rounded to the input type (the residual stream), and
y = LayerNorm(s) in f32 rounded to the input type, with SiLU applied to y on
request (the MLP embedders): one read of each input, one write of each
output. It has no backward: ``takes_kernel`` sends it every call on a CUDA
card that needs no gradient (sampling, validation), and the kernel raises on
what else it cannot take; training and the CPU keep the plain path. The JAX
package has no TPU kernel here.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from brepgen_tpu_torch.kernels import LAUNCH_COUNTS
from brepgen_tpu_torch.kernels import _build
from brepgen_tpu_torch.kernels import attention as _attention
from brepgen_tpu_torch.kernels.attention import _DTYPES

MAX_WIDTH = 1024  # csrc/add_layer_norm.cu: 8 chunks of 16 bytes a lane, in f32


def add_layer_norm_reference(x: torch.Tensor, delta: Optional[torch.Tensor],
                             weight: torch.Tensor, bias: torch.Tensor, eps: float,
                             silu: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version, the path of the CPU and of training:
    (s, y) with s = x + delta (x without delta) and y = LayerNorm(s) in f32,
    returned in s's type, then SiLU with ``silu``."""
    s = x if delta is None else x + delta
    y = F.layer_norm(s.float(), (s.shape[-1],), weight, bias, eps).to(s.dtype)
    return s, (F.silu(y) if silu else y)


def takes_kernel(x: torch.Tensor, delta: Optional[torch.Tensor], weight: torch.Tensor,
                 bias: torch.Tensor) -> bool:
    """Whether a norm hands x (and delta) to the kernel: on a CUDA card, with
    no gradient to take. There ``add_layer_norm`` raises on a layout, type or
    width it does not take (a multiple of 8 up to ``MAX_WIDTH``, x and delta
    both f32 or both bf16, contiguous) rather than falling back."""
    return _attention._on_card(x) and not _wants_grad(x, delta, weight, bias)


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def _refusal(x, delta, weight, bias) -> Optional[Exception]:
    """Why the kernel cannot take these tensors (their device aside), or None."""
    tensors = [t for t in (x, delta, weight, bias) if t is not None]
    if _wants_grad(*tensors):
        return RuntimeError("add_layer_norm: forward only; it has no backward (call it under "
                            "torch.no_grad() or on detached inputs)")
    if x.dim() < 1 or (delta is not None and delta.shape != x.shape):
        return ValueError(f"add_layer_norm: delta must have x's shape {tuple(x.shape)}, got "
                          f"{None if delta is None else tuple(delta.shape)}")
    W = x.shape[-1]
    if W % 8 or W > MAX_WIDTH:
        return ValueError(f"add_layer_norm: the width must be a multiple of 8 up to "
                          f"{MAX_WIDTH}, got {W}")
    if x.dtype not in _DTYPES or (delta is not None and delta.dtype != x.dtype):
        return TypeError(f"add_layer_norm: x and delta must both be float32 or both bfloat16, "
                         f"got {x.dtype}, {None if delta is None else delta.dtype}")
    if weight is None or bias is None or any(
            p.dtype != torch.float32 or p.shape != (W,) for p in (weight, bias)):
        return TypeError(f"add_layer_norm: weight and bias must be float32 [{W}]")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in tensors):
        return ValueError("add_layer_norm: every tensor must be contiguous and 16-byte aligned")
    return None


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("add_layer_norm")
    fn = lib.add_layer_norm_forward
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib


def add_layer_norm(x: torch.Tensor, delta: Optional[torch.Tensor], weight: torch.Tensor,
                   bias: torch.Tensor, eps: float, silu: bool = False,
                   keep_sum: bool = True) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """(s, y) as ``add_layer_norm_reference`` gives them, through the CUDA
    kernel: one launch on the current stream (capturable into a CUDA graph;
    none for no rows). s is x itself without delta, and None with delta and
    ``keep_sum`` False (the sum is then not written). Forward only: an input
    that requires grad raises, as does one the kernel does not take."""
    refusal = _refusal(x, delta, weight, bias)
    if refusal is not None:
        raise refusal
    devices = {t.device for t in (x, delta, weight, bias) if t is not None}
    if x.device.type != "cuda" or len(devices) != 1:
        raise ValueError(f"add_layer_norm: every tensor must lie on one CUDA device, got "
                         f"{sorted(map(str, devices))}")
    y = torch.empty_like(x)
    s = x if delta is None else torch.empty_like(x) if keep_sum else None
    W = x.shape[-1]
    rows = x.numel() // W
    if rows == 0:
        return s, y
    with torch.cuda.device(x.device):
        rc = _library().add_layer_norm_forward(
            x.data_ptr(), None if delta is None else delta.data_ptr(), weight.data_ptr(),
            bias.data_ptr(), None if delta is None or s is None else s.data_ptr(), y.data_ptr(),
            rows, W, _DTYPES[x.dtype], eps, int(silu),  # eps rounded to f32 by ctypes
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"add_layer_norm: kernel launch failed with CUDA error {rc}")
    LAUNCH_COUNTS["add_layer_norm"] += 1
    return s, y
