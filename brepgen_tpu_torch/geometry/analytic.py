"""Analytic surface/curve evaluators for native STEP ingestion.

The reference leans on OpenCASCADE for every surface class an external
STEP file can carry (``data_process/process_brep.py:13-231`` samples UV
grids through OCC regardless of the underlying geometry). The native
pipeline covers B-splines via ``geometry/bspline.py``; this module adds
the elementary analytic classes mainstream AP203/214 exporters emit —
PLANE, CYLINDRICAL/CONICAL/SPHERICAL/TOROIDAL_SURFACE and LINE, CIRCLE,
ELLIPSE — as closed-form evaluators plus the *inverse* parameterizations
the extractor needs to recover a face's UV domain from its boundary
(OCC gets that from BRepTools::UVBounds; here it is computed directly).

All evaluators are tiny-vector numpy (host-side extraction code, not a
device path). Conventions follow ISO 10303-42: ``u`` is the angular /
azimuthal parameter where one exists, periodic parameters live in
[0, 2*pi).

The port's own copy of ``brepgen_tpu/geometry/analytic.py``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

TWO_PI = 2.0 * np.pi


class Frame(NamedTuple):
    """An AXIS2_PLACEMENT_3D: origin + right-handed orthonormal basis."""

    origin: np.ndarray  # [3]
    z: np.ndarray       # axis
    x: np.ndarray       # reference direction (orthogonalized)

    @property
    def y(self) -> np.ndarray:
        return np.cross(self.z, self.x)

    def local(self, p: np.ndarray) -> np.ndarray:
        """World points [..., 3] -> local coordinates [..., 3]."""
        d = np.asarray(p, float) - self.origin
        return np.stack([d @ self.x, d @ self.y, d @ self.z], axis=-1)


def make_frame(origin, z=None, x=None) -> Frame:
    o = np.asarray(origin, float)
    zv = np.asarray(z if z is not None else (0.0, 0.0, 1.0), float)
    zv = zv / np.linalg.norm(zv)
    if x is None:
        # any direction not parallel to z
        seed = np.array([1.0, 0.0, 0.0]) if abs(zv[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
        xv = seed - zv * (seed @ zv)
    else:
        xv = np.asarray(x, float)
        xv = xv - zv * (xv @ zv)
    n = np.linalg.norm(xv)
    if n < 1e-12:
        seed = np.array([1.0, 0.0, 0.0]) if abs(zv[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
        xv = seed - zv * (seed @ zv)
        n = np.linalg.norm(xv)
    return Frame(o, zv, xv / n)


def _circ(frame: Frame, u):
    u = np.asarray(u, float)[..., None]
    return np.cos(u) * frame.x + np.sin(u) * frame.y


# ---------------------------------------------------------------- surfaces


class Plane(NamedTuple):
    frame: Frame
    u_periodic = False
    v_periodic = False

    def eval(self, u, v):
        u = np.asarray(u, float)[..., None]
        v = np.asarray(v, float)[..., None]
        return self.frame.origin + u * self.frame.x + v * self.frame.y

    def uv_of(self, p):
        loc = self.frame.local(p)
        return loc[..., 0], loc[..., 1]


class Cylinder(NamedTuple):
    frame: Frame
    radius: float
    u_periodic = True
    v_periodic = False

    def eval(self, u, v):
        v = np.asarray(v, float)[..., None]
        return self.frame.origin + self.radius * _circ(self.frame, u) + v * self.frame.z

    def uv_of(self, p):
        loc = self.frame.local(p)
        return np.arctan2(loc[..., 1], loc[..., 0]) % TWO_PI, loc[..., 2]


class Cone(NamedTuple):
    """CONICAL_SURFACE: ``radius`` at the reference plane, opening by
    ``semi_angle`` along +z (ISO 10303-42 4.4.4)."""

    frame: Frame
    radius: float
    semi_angle: float
    u_periodic = True
    v_periodic = False

    def eval(self, u, v):
        v = np.asarray(v, float)[..., None]
        r = self.radius + v * np.tan(self.semi_angle)
        return self.frame.origin + r * _circ(self.frame, u) + v * self.frame.z

    def uv_of(self, p):
        loc = self.frame.local(p)
        return np.arctan2(loc[..., 1], loc[..., 0]) % TWO_PI, loc[..., 2]


class Sphere(NamedTuple):
    frame: Frame
    radius: float
    u_periodic = True
    v_periodic = False  # latitude, [-pi/2, pi/2]

    def eval(self, u, v):
        v = np.asarray(v, float)[..., None]
        return self.frame.origin + self.radius * (
            np.cos(v) * _circ(self.frame, u) + np.sin(v) * self.frame.z
        )

    def uv_of(self, p):
        loc = self.frame.local(p)
        u = np.arctan2(loc[..., 1], loc[..., 0]) % TWO_PI
        v = np.arcsin(np.clip(loc[..., 2] / self.radius, -1.0, 1.0))
        return u, v


class Torus(NamedTuple):
    frame: Frame
    major_radius: float
    minor_radius: float
    u_periodic = True
    v_periodic = True

    def eval(self, u, v):
        v = np.asarray(v, float)[..., None]
        ring = self.major_radius + self.minor_radius * np.cos(v)
        return self.frame.origin + ring * _circ(self.frame, u) + (
            self.minor_radius * np.sin(v) * self.frame.z
        )

    def uv_of(self, p):
        loc = self.frame.local(p)
        u = np.arctan2(loc[..., 1], loc[..., 0]) % TWO_PI
        q = np.hypot(loc[..., 0], loc[..., 1]) - self.major_radius
        v = np.arctan2(loc[..., 2], q) % TWO_PI
        return u, v


# ------------------------------------------------------------------ curves


class Line(NamedTuple):
    point: np.ndarray
    vec: np.ndarray  # direction * magnitude; t in point + t*vec (ISO 10303-42)
    periodic = False

    def eval(self, t):
        return self.point + np.asarray(t, float)[..., None] * self.vec

    def t_of(self, p):
        d = np.asarray(p, float) - self.point
        return (d @ self.vec) / (self.vec @ self.vec)


class Circle(NamedTuple):
    frame: Frame
    radius: float
    periodic = True

    def eval(self, t):
        return self.frame.origin + self.radius * _circ(self.frame, t)

    def t_of(self, p):
        loc = self.frame.local(p)
        return np.arctan2(loc[..., 1], loc[..., 0]) % TWO_PI


class Ellipse(NamedTuple):
    frame: Frame
    semi_axis1: float
    semi_axis2: float
    periodic = True

    def eval(self, t):
        t = np.asarray(t, float)[..., None]
        return self.frame.origin + (
            self.semi_axis1 * np.cos(t) * self.frame.x
            + self.semi_axis2 * np.sin(t) * self.frame.y
        )

    def t_of(self, p):
        loc = self.frame.local(p)
        return np.arctan2(loc[..., 1] / self.semi_axis2, loc[..., 0] / self.semi_axis1) % TWO_PI


ANALYTIC_SURFACES = (Plane, Cylinder, Cone, Sphere, Torus)
ANALYTIC_CURVES = (Line, Circle, Ellipse)


def curve_param_range(curve, p_start, p_end) -> Tuple[float, float]:
    """Trim parameters of an analytic curve from its edge's vertex points.

    Periodic curves follow the STEP/OCC convention: the edge runs in the
    direction of increasing parameter from t0, so t1 <= t0 unwraps by one
    period; coincident endpoints mean the full closed curve.
    """
    t0 = float(curve.t_of(p_start))
    t1 = float(curve.t_of(p_end))
    if curve.periodic:
        if np.allclose(p_start, p_end, atol=1e-9):
            return 0.0, TWO_PI
        if t1 <= t0 + 1e-12:
            t1 += TWO_PI
    return t0, t1


def periodic_range(angles: np.ndarray, full_gap: float = 0.5) -> Tuple[float, float]:
    """Angular domain covered by boundary samples of a periodic parameter.

    Sorts the angles and finds the largest circular gap: if no gap exceeds
    ``full_gap`` radians the boundary wraps the whole period (full
    revolution); otherwise the domain is the complement of that gap.
    """
    a = np.sort(np.asarray(angles, float) % TWO_PI)
    if len(a) == 0:
        return 0.0, TWO_PI
    gaps = np.diff(np.concatenate([a, a[:1] + TWO_PI]))
    i = int(np.argmax(gaps))
    if gaps[i] < full_gap:
        return 0.0, TWO_PI
    if i == len(a) - 1:  # largest gap wraps past 2*pi: domain is contiguous
        return float(a[0]), float(a[-1])
    return float(a[i + 1]), float(a[i] + TWO_PI)


def surface_uv_domain(surface, boundary_pts: np.ndarray) -> Tuple[Tuple[float, float], Tuple[float, float]]:
    """(u0,u1), (v0,v1) covering the face from its boundary samples."""
    u, v = surface.uv_of(boundary_pts.reshape(-1, 3))
    if surface.u_periodic:
        u_rng = periodic_range(u)
    else:
        u_rng = (float(u.min()), float(u.max()))
    if surface.v_periodic:
        v_rng = periodic_range(v)
    else:
        v_rng = (float(v.min()), float(v.max()))
    return u_rng, v_rng
