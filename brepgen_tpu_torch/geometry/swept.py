"""Swept and offset surface evaluators for native STEP ingestion.

SURFACE_OF_LINEAR_EXTRUSION, SURFACE_OF_REVOLUTION and OFFSET_SURFACE
(ISO 10303-42 sweeps/offsets) with the inverse parameterizations the
extractor needs to recover a face's UV domain from its boundary samples.
The reference samples every surface class through OCC's uvgrid regardless
of geometry (``data_process/convert_utils.py:290-313``); these evaluators
give the native pipeline the same any-surface coverage without a CAD
kernel.

Parameter conventions match OCC/ISO 10303-42:
  * linear extrusion: ``sigma(u, v) = C(u) + v * V`` — u is the directrix
    parameter, v the extrusion distance along the (scaled) axis vector;
  * revolution: ``sigma(u, v) = rot(axis, u)(C(v))`` — u is the rotation
    angle in [0, 2*pi), v the directrix parameter;
  * offset: ``sigma(u, v) = S(u, v) + d * n(u, v)`` with ``n`` the unit
    normal ``S_u x S_v / |.|`` of the basis surface. Offsets of the
    elementary analytic classes reduce in closed form to the same class
    (``make_offset``); only free-form bases need the numeric evaluator.

Inverses for the general (B-spline-directrix) sweeps have no closed form;
they use a vectorized coarse-scan + interval-refinement minimizer
(``_min_scan``) over the directrix parameter — exact to ~1e-6 of the
domain in 3 rounds, plenty for UV-box recovery (the sampled grid itself
is evaluated forward and lies exactly on the surface).

Host-side extraction code (tiny numpy), not a device path. The port's own
copy of ``brepgen_tpu/geometry/swept.py``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

from brepgen_tpu_torch.geometry import analytic
from brepgen_tpu_torch.geometry.bspline import (
    BsplineCurve,
    BsplineSurface,
    NurbsCurve,
    NurbsSurface,
    eval_bspline_curve,
    eval_bspline_surface,
    eval_nurbs_curve,
    eval_nurbs_surface,
)

TWO_PI = 2.0 * np.pi


def curve_eval(curve, t) -> np.ndarray:
    """Evaluate any supported curve (analytic / B-spline / NURBS) at ``t``
    of arbitrary shape -> ``t.shape + (3,)``."""
    t = np.asarray(t, float)
    if isinstance(curve, NurbsCurve):
        return eval_nurbs_curve(curve, t.ravel()).reshape(t.shape + (3,))
    if isinstance(curve, BsplineCurve):
        return eval_bspline_curve(curve, t.ravel()).reshape(t.shape + (3,))
    return curve.eval(t)


def curve_domain(curve) -> Tuple[float, float, bool]:
    """(t0, t1, periodic) natural parameter domain of a directrix."""
    if isinstance(curve, (BsplineCurve, NurbsCurve)):
        return float(curve.knots[0]), float(curve.knots[-1]), False
    if getattr(curve, "periodic", False):
        return 0.0, TWO_PI, True
    # LINE: unbounded parameter; inverses derive a data-driven bracket
    # (or solve in closed form) instead of scanning a fixed window.
    return -np.inf, np.inf, False


def _min_scan(cost_fn, lo, hi, n_pts: int, clamp_lo=None, clamp_hi=None,
              n: int = 96, rounds: int = 4) -> np.ndarray:
    """Vectorized 1-D minimization per query point.

    cost_fn(ts: [P, K]) -> [P, K]; returns argmin t*, shape [P]. Each
    round scans n samples per point and narrows to +-1 sample spacing.
    """
    lo = np.full(n_pts, lo, float)
    hi = np.full(n_pts, hi, float)
    t_best = lo
    for _ in range(rounds):
        ts = lo[:, None] + (hi - lo)[:, None] * np.linspace(0.0, 1.0, n)
        c = cost_fn(ts)
        i = np.argmin(c, axis=-1)
        t_best = np.take_along_axis(ts, i[:, None], axis=-1)[:, 0]
        step = (hi - lo) / (n - 1)
        lo, hi = t_best - step, t_best + step
        if clamp_lo is not None:
            lo = np.maximum(lo, clamp_lo)
        if clamp_hi is not None:
            hi = np.minimum(hi, clamp_hi)
    return t_best


class ExtrudedSurface(NamedTuple):
    """SURFACE_OF_LINEAR_EXTRUSION: directrix swept along ``vec``."""

    curve: object
    vec: np.ndarray        # extrusion_axis VECTOR: direction * magnitude
    u0: float              # directrix parameter domain
    u1: float
    u_periodic: bool
    v_periodic = False

    def eval(self, u, v):
        v = np.asarray(v, float)[..., None]
        return curve_eval(self.curve, u) + v * self.vec

    def uv_of(self, p):
        p = np.asarray(p, float)
        flat = p.reshape(-1, 3)

        if isinstance(self.curve, analytic.Line):
            # line swept along vec is a plane: solve the 2x2 normal system
            # C(u) + v * vec = p exactly
            b1, b2 = self.curve.vec, self.vec
            d = flat - self.curve.point
            g = np.array([[b1 @ b1, b1 @ b2], [b2 @ b1, b2 @ b2]])
            rhs = np.stack([d @ b1, d @ b2], axis=-1)
            sol = rhs @ np.linalg.inv(g).T
            return (
                sol[..., 0].reshape(p.shape[:-1]),
                sol[..., 1].reshape(p.shape[:-1]),
            )

        vhat = self.vec / np.linalg.norm(self.vec)

        def cost(ts):
            c = curve_eval(self.curve, ts)               # [P, K, 3]
            d = flat[:, None, :] - c
            perp = d - (d @ vhat)[..., None] * vhat
            return np.sum(perp**2, -1)

        clamp = (None, None) if self.u_periodic else (self.u0, self.u1)
        u = _min_scan(cost, self.u0, self.u1, len(flat), *clamp)
        vv = ((flat - curve_eval(self.curve, u)) @ self.vec) / (
            self.vec @ self.vec
        )
        if self.u_periodic:
            u = u % TWO_PI
        return u.reshape(p.shape[:-1]), vv.reshape(p.shape[:-1])


class RevolvedSurface(NamedTuple):
    """SURFACE_OF_REVOLUTION: directrix rotated about ``frame``'s z axis."""

    curve: object
    frame: analytic.Frame  # AXIS1_PLACEMENT: origin + axis (x arbitrary)
    v0: float              # directrix parameter domain
    v1: float
    v_periodic: bool
    u_periodic = True      # rotation angle

    def eval(self, u, v):
        loc = self.frame.local(curve_eval(self.curve, v))
        u = np.asarray(u, float)
        cu, su = np.cos(u), np.sin(u)
        xr = cu * loc[..., 0] - su * loc[..., 1]
        yr = su * loc[..., 0] + cu * loc[..., 1]
        f = self.frame
        return (
            f.origin
            + xr[..., None] * f.x
            + yr[..., None] * f.y
            + loc[..., 2][..., None] * f.z
        )

    def uv_of(self, p):
        p = np.asarray(p, float)
        flat = p.reshape(-1, 3)
        loc = self.frame.local(flat)
        r_p = np.hypot(loc[:, 0], loc[:, 1])
        th_p = np.arctan2(loc[:, 1], loc[:, 0])
        z_p = loc[:, 2]

        def cost(ts):
            c = self.frame.local(curve_eval(self.curve, ts))  # [P, K, 3]
            r_c = np.hypot(c[..., 0], c[..., 1])
            return (r_c - r_p[:, None]) ** 2 + (c[..., 2] - z_p[:, None]) ** 2

        v0, v1 = self.v0, self.v1
        if not np.isfinite(v0):  # Line directrix: data-driven bracket
            a = self.frame.local(curve_eval(self.curve, np.zeros(1)))[0]
            b = curve_eval(self.curve, np.ones(1))[0] - curve_eval(
                self.curve, np.zeros(1)
            )[0]
            reach = (np.abs(loc).max() + np.linalg.norm(a)) / max(
                np.linalg.norm(b), 1e-12
            )
            v0, v1 = -reach - 1.0, reach + 1.0
        clamp = (None, None) if self.v_periodic else (v0, v1)
        v = _min_scan(cost, v0, v1, len(flat), *clamp)
        cb = self.frame.local(curve_eval(self.curve, v))
        th_c = np.arctan2(cb[..., 1], cb[..., 0])
        u = (th_p - th_c) % TWO_PI
        if self.v_periodic:
            v = v % TWO_PI
        return u.reshape(p.shape[:-1]), v.reshape(p.shape[:-1])


class OffsetSurface(NamedTuple):
    """OFFSET_SURFACE over a free-form basis: numeric normal offset.

    Analytic bases never reach this class — ``make_offset`` reduces them
    in closed form. ``uv_of`` is unused for B-spline bases (the extractor
    samples their full knot domain), so none is provided.
    """

    base: object           # BsplineSurface or NurbsSurface
    distance: float
    u_periodic = False
    v_periodic = False

    def _base_eval(self, u, v):
        u = np.asarray(u, float)
        v = np.asarray(v, float)
        if isinstance(self.base, NurbsSurface):
            return eval_nurbs_surface(self.base, u, v)
        return eval_bspline_surface(self.base, u, v)

    def domain(self) -> Tuple[Tuple[float, float], Tuple[float, float]]:
        ku, kv = self.base.knots_u, self.base.knots_v
        return (float(ku[0]), float(ku[-1])), (float(kv[0]), float(kv[-1]))

    def eval_grid(self, u: np.ndarray, v: np.ndarray) -> np.ndarray:
        """[len(u), len(v), 3] offset samples (central-difference normals,
        one-sided at the domain ends)."""
        (u0, u1), (v0, v1) = self.domain()
        hu = max(u1 - u0, 1e-9) * 1e-5
        hv = max(v1 - v0, 1e-9) * 1e-5
        s = self._base_eval(u, v)
        du = (
            self._base_eval(np.minimum(u + hu, u1), v)
            - self._base_eval(np.maximum(u - hu, u0), v)
        )
        dv = (
            self._base_eval(u, np.minimum(v + hv, v1))
            - self._base_eval(u, np.maximum(v - hv, v0))
        )
        n = np.cross(du, dv)
        norm = np.linalg.norm(n, axis=-1, keepdims=True)
        n = n / np.where(norm < 1e-14, 1.0, norm)
        return s + self.distance * n


class TrimmedSurface(NamedTuple):
    """RECTANGULAR_TRIMMED_SURFACE over a free-form basis: the trim
    rectangle becomes the sampled parameter domain.

    Only free-form bases reach this class — analytic and swept bases
    recover their face domain from projected boundary points, so
    ``make_trimmed`` returns them unchanged. B-spline/NURBS/offset bases
    are otherwise sampled over their FULL knot domain, which would ignore
    the trim rectangle; this wrapper restricts the grid to it (the
    reference samples the trimmed face's own UV bounds through OCC,
    ``data_process/convert_utils.py:290-313``).
    """

    base: object  # BsplineSurface, NurbsSurface, or OffsetSurface
    u0: float
    u1: float
    v0: float
    v1: float
    u_periodic = False
    v_periodic = False

    def domain(self) -> Tuple[Tuple[float, float], Tuple[float, float]]:
        return (self.u0, self.u1), (self.v0, self.v1)

    def eval_grid(self, u: np.ndarray, v: np.ndarray) -> np.ndarray:
        if isinstance(self.base, OffsetSurface):
            return self.base.eval_grid(u, v)
        u = np.asarray(u, float)
        v = np.asarray(v, float)
        if isinstance(self.base, NurbsSurface):
            return eval_nurbs_surface(self.base, u, v)
        return eval_bspline_surface(self.base, u, v)


def make_trimmed(base, u0, u1, v0, v1):
    """RECTANGULAR_TRIMMED_SURFACE -> domain-restricted wrapper for
    free-form bases; pass-through for bases whose face domain the
    extractor recovers from boundary projection anyway."""
    if isinstance(base, (BsplineSurface, NurbsSurface, OffsetSurface)):
        return TrimmedSurface(base, float(u0), float(u1), float(v0), float(v1))
    return base


def make_offset(base, distance: float):
    """OFFSET_SURFACE -> closed-form same-class surface where possible.

    Offsets of the elementary analytic classes are instances of the same
    class (normal directions derived from S_u x S_v per ISO 10303-42):
    plane -> translated plane; cylinder/sphere -> radius + d;
    torus -> minor radius + d; cone -> radius + d / cos(semi_angle).
    Free-form bases get the numeric ``OffsetSurface``.
    """
    d = float(distance)
    if isinstance(base, analytic.Plane):
        f = base.frame
        return analytic.Plane(analytic.Frame(f.origin + d * f.z, f.z, f.x))
    if isinstance(base, analytic.Cylinder):
        return analytic.Cylinder(base.frame, base.radius + d)
    if isinstance(base, analytic.Sphere):
        return analytic.Sphere(base.frame, base.radius + d)
    if isinstance(base, analytic.Torus):
        return analytic.Torus(base.frame, base.major_radius, base.minor_radius + d)
    if isinstance(base, analytic.Cone):
        # sigma_off = origin + (R + v tan(a) + d cos(a)) c(u) + (v - d sin(a)) z
        # == Cone(origin, R + d / cos(a), a) under w = v - d sin(a)
        return analytic.Cone(
            base.frame, base.radius + d / np.cos(base.semi_angle), base.semi_angle
        )
    if isinstance(base, (BsplineSurface, NurbsSurface)):
        return OffsetSurface(base, d)
    raise ValueError(f"unsupported OFFSET_SURFACE basis {type(base).__name__}")


def make_extruded(curve, vec) -> ExtrudedSurface:
    t0, t1, per = curve_domain(curve)
    return ExtrudedSurface(curve, np.asarray(vec, float), t0, t1, per)


def make_revolved(curve, frame: analytic.Frame) -> RevolvedSurface:
    t0, t1, per = curve_domain(curve)
    return RevolvedSurface(curve, frame, t0, t1, per)
