"""Pairwise Chamfer matrix of point clouds: the CUDA kernel's wrapper and its
plain version.

Port of ``brepgen_tpu/kernels/chamfer.py:_chamfer_kernel`` (kernel K4): for
sample clouds [S, P, 3] and reference clouds [R, P, 3], f32, the [S, R]
matrix of the mean squared nearest-neighbour distance in both directions,
over the first ``n_pts`` points of every cloud (the rest is padding). The
kernel is ``csrc/chamfer.cu``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from brepgen_tpu_torch.kernels import LAUNCH_COUNTS
from brepgen_tpu_torch.kernels import _build

# elements of one [bs, br, n, q] distance slab of the plain version
PLAIN_SLAB = {"cpu": 1 << 22, "cuda": 1 << 26}


def chamfer_matrix_reference(x: torch.Tensor, y: torch.Tensor,
                             n_pts: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version: blocked direct differences, f32.

    Counterpart of the Pallas body and of ``metrics.py:_chamfer_block``, in
    the direct-difference form ((dx^2 + dy^2) + dz^2): pair blocks of
    ``bs`` x ``br`` clouds and chunks of ``q`` reference points keep the
    [bs, br, n, q] slab bounded; the forward direction keeps a running min
    over chunks, the reverse direction is complete within a chunk.
    """
    S, P, _ = x.shape
    R = y.shape[0]
    n = P if n_pts is None else n_pts
    x = x[:, :n].float()
    y = y[:, :n].float()
    budget = PLAIN_SLAB["cuda" if x.is_cuda else "cpu"]
    q = max(1, min(n, budget // n))
    pairs = max(1, budget // (n * q))
    bs = max(1, min(S, math.isqrt(pairs)))
    br = max(1, min(R, pairs // bs))
    out = torch.empty((S, R), dtype=torch.float32, device=x.device)
    for i in range(0, S, bs):
        xi = x[i:i + bs, None, :, None, :]                # [bs, 1, n, 1, 3]
        for j in range(0, R, br):
            fwd = None
            rev = torch.zeros((xi.shape[0], min(br, R - j)), device=x.device)
            for q0 in range(0, n, q):
                yj = y[None, j:j + br, None, q0:q0 + q, :]  # [1, br, 1, q, 3]
                d2 = None
                for c in range(3):
                    diff = xi[..., c] - yj[..., c]          # [bs, br, n, q]
                    d2 = diff * diff if d2 is None else d2 + diff * diff
                m = d2.amin(dim=3)
                fwd = m if fwd is None else torch.minimum(fwd, m)
                rev += d2.amin(dim=2).sum(dim=2)
            out[i:i + bs, j:j + br] = fwd.sum(dim=2) / n + rev / n
    return out


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("chamfer")
    fn = lib.chamfer_matrix_forward
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    lib.chamfer_max_points.argtypes = []
    lib.chamfer_max_points.restype = ctypes.c_int
    return lib


def chamfer_matrix(x: torch.Tensor, y: torch.Tensor,
                   n_pts: Optional[int] = None) -> torch.Tensor:
    """[S, P, 3] x [R, P, 3] f32 -> [S, R] f32 through the CUDA kernel, one
    launch for the whole matrix.

    Tensors on the CPU take the plain version; CUDA tensors launch the
    kernel or raise. Forward only, as the TPU kernel: an input that requires
    grad raises.
    """
    if torch.is_grad_enabled() and (x.requires_grad or y.requires_grad):
        raise RuntimeError("chamfer_matrix: forward only; it has no backward (call it "
                           "under torch.no_grad() or on detached inputs)")
    for name, t in (("x", x), ("y", y)):
        if t.dim() != 3 or t.shape[-1] != 3:
            raise ValueError(f"chamfer_matrix: {name} must be [N, P, 3], got {tuple(t.shape)}")
    if x.shape[1] != y.shape[1]:
        raise ValueError(f"chamfer_matrix: point counts differ ({x.shape[1]} and {y.shape[1]})")
    S, P, _ = x.shape
    R = y.shape[0]
    n = P if n_pts is None else int(n_pts)
    if not 1 <= n <= P:
        raise ValueError(f"chamfer_matrix: n_pts must be in [1, {P}], got {n}")
    if x.device.type == "cpu" and y.device.type == "cpu":
        return chamfer_matrix_reference(x, y, n)
    if x.device.type != "cuda" or y.device != x.device:
        raise ValueError(f"chamfer_matrix: x on {x.device} and y on {y.device}; "
                         "both must be on one CUDA device (or both on the CPU)")
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"chamfer_matrix: dtype must be float32, got {x.dtype} and {y.dtype}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("chamfer_matrix: x and y must be contiguous")
    out = torch.empty((S, R), dtype=torch.float32, device=x.device)  # the kernel writes all
    if S == 0 or R == 0:
        return out
    lib = _library()
    if n > lib.chamfer_max_points():
        raise ValueError(f"chamfer_matrix: at most {lib.chamfer_max_points()} points per "
                         f"cloud, got {n}")
    with torch.cuda.device(x.device):
        rc = lib.chamfer_matrix_forward(
            x.data_ptr(), y.data_ptr(), out.data_ptr(), S, R, P, n,
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"chamfer_matrix: kernel launch failed with CUDA error {rc}")
    LAUNCH_COUNTS["chamfer"] += 1
    return out
