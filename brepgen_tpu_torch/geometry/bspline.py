"""Least-squares B-spline fitting of sampled curves and surfaces.

The reference delegates to OpenCASCADE (``GeomAPI_PointsToBSpline*``,
``utils.py:834,846-853``) to turn the generated 32-point curves / 32x32
grids into parametric geometry for STEP export. Here fitting is done
directly: cubic B-splines, uniform parameterization over [0, 1], solved as
a (tiny, well-conditioned) linear least-squares per coordinate. Output is
(knots, control points) in standard B-spline form -- exactly what the STEP
writer needs for B_SPLINE_{CURVE,SURFACE}_WITH_KNOTS entities.

The port's own copy of ``brepgen_tpu/geometry/bspline.py``: the fitting
half serves the STEP writer, the evaluation half and the rational types the
STEP reader and the extraction (``geometry/native_extract.py``).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np


class BsplineCurve(NamedTuple):
    degree: int
    knots: np.ndarray       # full knot vector, length n_ctrl + degree + 1
    control: np.ndarray     # [n_ctrl, 3]


class BsplineSurface(NamedTuple):
    degree_u: int
    degree_v: int
    knots_u: np.ndarray
    knots_v: np.ndarray
    control: np.ndarray     # [n_u, n_v, 3]


def _open_uniform_knots(n_ctrl: int, degree: int) -> np.ndarray:
    """Clamped uniform knot vector on [0, 1]."""
    n_inner = n_ctrl - degree - 1
    inner = np.linspace(0, 1, n_inner + 2)[1:-1] if n_inner > 0 else np.array([])
    return np.concatenate([np.zeros(degree + 1), inner, np.ones(degree + 1)])


def _bspline_basis(t: np.ndarray, knots: np.ndarray, degree: int, n_ctrl: int) -> np.ndarray:
    """Cox-de Boor basis matrix [len(t), n_ctrl]."""
    t = np.asarray(t, float)
    # degree-0 basis
    B = np.zeros((len(t), len(knots) - 1))
    for i in range(len(knots) - 1):
        left, right = knots[i], knots[i + 1]
        if right > left:
            B[:, i] = (t >= left) & (t < right)
    # clamp t == 1 into the last non-empty span
    last = np.where(np.diff(knots) > 0)[0][-1]
    B[t >= knots[-1] - 1e-12, :] = 0
    B[t >= knots[-1] - 1e-12, last] = 1

    for d in range(1, degree + 1):
        Bn = np.zeros((len(t), len(knots) - d - 1))
        for i in range(len(knots) - d - 1):
            denom1 = knots[i + d] - knots[i]
            denom2 = knots[i + d + 1] - knots[i + 1]
            term = 0.0
            if denom1 > 0:
                term = (t - knots[i]) / denom1 * B[:, i]
            if denom2 > 0:
                term = term + (knots[i + d + 1] - t) / denom2 * B[:, i + 1]
            Bn[:, i] = term
        B = Bn
    return B[:, :n_ctrl]


def fit_bspline_curve(points: np.ndarray, degree: int = 3, n_ctrl: int = 12) -> BsplineCurve:
    """Least-squares fit of [N, 3] sampled points, endpoints interpolated."""
    N = len(points)
    n_ctrl = min(n_ctrl, N)
    t = np.linspace(0, 1, N)
    knots = _open_uniform_knots(n_ctrl, degree)
    A = _bspline_basis(t, knots, degree, n_ctrl)
    ctrl, *_ = np.linalg.lstsq(A, points, rcond=None)
    # clamp endpoints exactly (post-processing snapped them to vertices)
    ctrl[0] = points[0]
    ctrl[-1] = points[-1]
    return BsplineCurve(degree, knots, ctrl)


def fit_bspline_surface(
    grid: np.ndarray, degree: int = 3, n_ctrl: int = 12
) -> BsplineSurface:
    """Least-squares tensor-product fit of a [Nu, Nv, 3] grid."""
    Nu, Nv, _ = grid.shape
    nu, nv = min(n_ctrl, Nu), min(n_ctrl, Nv)
    ku = _open_uniform_knots(nu, degree)
    kv = _open_uniform_knots(nv, degree)
    Au = _bspline_basis(np.linspace(0, 1, Nu), ku, degree, nu)   # [Nu, nu]
    Av = _bspline_basis(np.linspace(0, 1, Nv), kv, degree, nv)   # [Nv, nv]
    # Solve (Au x Av) C = G  ->  C = Au+ G (Av+)^T, per coordinate
    Au_pinv = np.linalg.pinv(Au)  # [nu, Nu]
    Av_pinv = np.linalg.pinv(Av)  # [nv, Nv]
    ctrl = np.einsum("ui,vj,ijd->uvd", Au_pinv, Av_pinv, grid)
    return BsplineSurface(degree, degree, ku, kv, ctrl)


def eval_bspline_curve(curve: BsplineCurve, t: np.ndarray) -> np.ndarray:
    B = _bspline_basis(t, curve.knots, curve.degree, len(curve.control))
    return B @ curve.control


def eval_bspline_surface(surf: BsplineSurface, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Evaluate on the tensor grid u x v -> [len(u), len(v), 3]."""
    Bu = _bspline_basis(u, surf.knots_u, surf.degree_u, surf.control.shape[0])
    Bv = _bspline_basis(v, surf.knots_v, surf.degree_v, surf.control.shape[1])
    return np.einsum("iu,jv,uvd->ijd", Bu, Bv, surf.control)


class NurbsCurve(NamedTuple):
    """Rational B-spline curve (homogeneous weights); exact for conics,
    which external STEP files often carry as RATIONAL_B_SPLINE_CURVE
    complex entities instead of CIRCLE/ELLIPSE."""

    degree: int
    knots: np.ndarray
    control: np.ndarray     # [n_ctrl, 3]
    weights: np.ndarray     # [n_ctrl]


class NurbsSurface(NamedTuple):
    degree_u: int
    degree_v: int
    knots_u: np.ndarray
    knots_v: np.ndarray
    control: np.ndarray     # [n_u, n_v, 3]
    weights: np.ndarray     # [n_u, n_v]


def eval_nurbs_curve(curve: NurbsCurve, t: np.ndarray) -> np.ndarray:
    B = _bspline_basis(t, curve.knots, curve.degree, len(curve.control))
    num = B @ (curve.weights[:, None] * curve.control)
    den = B @ curve.weights
    return num / den[:, None]


def eval_nurbs_surface(surf: NurbsSurface, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Evaluate on the tensor grid u x v -> [len(u), len(v), 3]."""
    Bu = _bspline_basis(u, surf.knots_u, surf.degree_u, surf.control.shape[0])
    Bv = _bspline_basis(v, surf.knots_v, surf.degree_v, surf.control.shape[1])
    num = np.einsum("iu,jv,uvd->ijd", Bu, Bv, surf.weights[..., None] * surf.control)
    den = np.einsum("iu,jv,uv->ij", Bu, Bv, surf.weights)
    return num / den[..., None]


def knots_with_multiplicity(knots: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Collapse a full knot vector into (unique_knots, multiplicities) --
    the representation STEP entities use."""
    uniq, counts = np.unique(np.round(knots, 12), return_counts=True)
    return uniq, counts
