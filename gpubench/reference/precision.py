"""Products in the reference's precision: ``f32`` (float32, TF32 off),
``fp8`` (inputs of every product rounded to float8 e4m3 with a per-tensor
scale, accumulated in float32; in training the gradient passes the
rounding unchanged: the control of a bf16 configuration) or
``tf32`` (float32 products with TF32 on: the control of an f32 one)."""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

PRECISIONS = ("f32", "fp8", "tf32")
FP8_MAX = 448.0  # largest finite float8 e4m3fn


@contextlib.contextmanager
def exact(prec: str = "f32"):
    """TF32 off for ``f32`` and ``fp8``, on for ``tf32``; restored after."""
    if prec not in PRECISIONS:
        raise ValueError(f"precision {prec!r}; one of {PRECISIONS}")
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    on = prec == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def q(x: torch.Tensor, prec: str) -> torch.Tensor:
    """``x`` as a product's input sees it: f32, or rounded to fp8 e4m3 or to
    TF32's 10-bit mantissa (rounded here, so that the control does not hang
    on whether a library picks its tensor-core path for a given shape)."""
    x = x.float()
    if prec == "tf32":
        bits = x.detach().contiguous().view(torch.int32)
        rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
        return x + (rounded - x.detach())
    if prec != "fp8":
        return x
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    rounded = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (rounded - x.detach())  # the rounded value; the gradient passes through


def linear(x, w, b, prec):
    return F.linear(q(x, prec), q(w, prec), None if b is None else b.float())


def conv2d(x, w, b, prec, **kw):
    return F.conv2d(q(x, prec), q(w, prec), None if b is None else b.float(), **kw)


def conv1d(x, w, b, prec, **kw):
    return F.conv1d(q(x, prec), q(w, prec), None if b is None else b.float(), **kw)


def einsum(eq, a, b, prec):
    return torch.einsum(eq, q(a, prec), q(b, prec))
