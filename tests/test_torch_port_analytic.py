"""Port: the analytic, swept and B-spline evaluators of STEP ingestion
(``geometry/analytic.py``, ``swept.py``, ``bspline.py``) against the JAX
package's.

Each surface and curve class is built in both packages from the same
parameters drawn from a numpy seed, then evaluated and inverted at the same
seeded points: every result equal (atol 0; both run the same numpy
operations in the same order on the same host, so no summation order
differs).
"""

import numpy as np
import pytest

from brepgen_tpu.geometry import analytic as j_an
from brepgen_tpu.geometry import bspline as j_bs
from brepgen_tpu.geometry import swept as j_sw
from brepgen_tpu_torch.geometry import analytic as t_an
from brepgen_tpu_torch.geometry import bspline as t_bs
from brepgen_tpu_torch.geometry import swept as t_sw


def _eq(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _frame(mod, rng):
    return mod.make_frame(rng.normal(size=3), rng.normal(size=3), rng.normal(size=3))


def _surfaces(mod, seed):
    """The five analytic surface classes on seeded frames and radii."""
    rng = np.random.default_rng(seed)
    fr = [_frame(mod, rng) for _ in range(5)]
    r = rng.uniform(0.5, 2.0, size=5)
    return {
        "plane": mod.Plane(fr[0]),
        "cylinder": mod.Cylinder(fr[1], r[0]),
        "cone": mod.Cone(fr[2], r[1], rng.uniform(0.1, 0.6)),
        "sphere": mod.Sphere(fr[3], r[2]),
        "torus": mod.Torus(fr[4], r[3] + 1.5, r[4] * 0.5),
    }


def _curves(mod, seed):
    rng = np.random.default_rng(seed)
    return {
        "line": mod.Line(rng.normal(size=3), rng.normal(size=3)),
        "circle": mod.Circle(_frame(mod, rng), rng.uniform(0.5, 2.0)),
        "ellipse": mod.Ellipse(_frame(mod, rng), rng.uniform(1.0, 2.0), rng.uniform(0.3, 0.9)),
    }


def _bspline_pair(seed, rational=False):
    rng = np.random.default_rng(seed)
    gx, gy = np.meshgrid(np.linspace(0, 1, 9), np.linspace(0, 1, 7), indexing="ij")
    grid = np.stack([gx, gy, 0.3 * np.sin(3 * gx + rng.uniform()) * np.cos(2 * gy)], -1)
    pts = np.cumsum(rng.normal(size=(11, 3)), axis=0)
    out = []
    for mod in (j_bs, t_bs):
        s = mod.fit_bspline_surface(grid, degree=3, n_ctrl=6)
        c = mod.fit_bspline_curve(pts, degree=3, n_ctrl=7)
        if rational:
            ws = np.random.default_rng(seed + 1).uniform(0.5, 2.0, size=s.control.shape[:2])
            wc = np.random.default_rng(seed + 2).uniform(0.5, 2.0, size=len(c.control))
            s = mod.NurbsSurface(s.degree_u, s.degree_v, s.knots_u, s.knots_v, s.control, ws)
            c = mod.NurbsCurve(c.degree, c.knots, c.control, wc)
        out.append((s, c))
    return out


@pytest.mark.parametrize("name", ["plane", "cylinder", "cone", "sphere", "torus"])
def test_surface_eval_and_inverse(name):
    js, ts = _surfaces(j_an, 0)[name], _surfaces(t_an, 0)[name]
    rng = np.random.default_rng(1)
    u, v = rng.uniform(0, 2 * np.pi, size=(2, 40, 3))
    v = v if name in ("sphere", "torus") else v - np.pi
    if name == "sphere":
        v = v / 4 - np.pi / 4
    p = js.eval(u, v)
    _eq(ts.eval(u, v), p)
    for got, want in zip(ts.uv_of(p), js.uv_of(p)):
        _eq(got, want)
    boundary = p.reshape(-1, 3)[:24]
    assert t_an.surface_uv_domain(ts, boundary) == j_an.surface_uv_domain(js, boundary)


@pytest.mark.parametrize("name", ["line", "circle", "ellipse"])
def test_curve_eval_inverse_and_range(name):
    jc, tc = _curves(j_an, 2)[name], _curves(t_an, 2)[name]
    t = np.random.default_rng(3).uniform(0, 2 * np.pi, size=50)
    p = jc.eval(t)
    _eq(tc.eval(t), p)
    _eq(tc.t_of(p), jc.t_of(p))
    for a, b in ((p[0], p[1]), (p[1], p[0]), (p[2], p[2])):
        assert t_an.curve_param_range(tc, a, b) == j_an.curve_param_range(jc, a, b)


def test_frames_and_periodic_range():
    rng = np.random.default_rng(4)
    for z, x in ((rng.normal(size=3), None), ((0.95, 0.1, 0.0), None),
                 ((0, 0, 1), (0, 0, 2)), (rng.normal(size=3), rng.normal(size=3))):
        jf, tf = j_an.make_frame((1, 2, 3), z, x), t_an.make_frame((1, 2, 3), z, x)
        for a, b in zip(tf, jf):
            _eq(a, b)
        _eq(tf.y, jf.y)
        q = rng.normal(size=(5, 3))
        _eq(tf.local(q), jf.local(q))
    cases = [np.linspace(0, 2 * np.pi, 64, endpoint=False), np.linspace(1.0, 2.5, 16),
             np.concatenate([np.linspace(5.8, 6.28, 8), np.linspace(0.0, 0.5, 8)]),
             rng.uniform(0, 7, size=30), np.array([])]
    for a in cases:
        assert t_an.periodic_range(a) == j_an.periodic_range(a)


def test_bspline_and_nurbs_eval():
    for rational in (False, True):
        (js, jc), (ts, tc) = _bspline_pair(5, rational)
        u = np.random.default_rng(6).uniform(0, 1, size=33)
        u[:2] = 0.0, 1.0
        v = np.linspace(0, 1, 17)
        if rational:
            _eq(t_bs.eval_nurbs_surface(ts, u, v), j_bs.eval_nurbs_surface(js, u, v))
            _eq(t_bs.eval_nurbs_curve(tc, u), j_bs.eval_nurbs_curve(jc, u))
        else:
            _eq(t_bs.eval_bspline_surface(ts, u, v), j_bs.eval_bspline_surface(js, u, v))
            _eq(t_bs.eval_bspline_curve(tc, u), j_bs.eval_bspline_curve(jc, u))
        for got, want in zip(t_bs.knots_with_multiplicity(ts.knots_u),
                             j_bs.knots_with_multiplicity(js.knots_u)):
            _eq(got, want)


def _directrices(an, bs, seed):
    """A line, a circle and a cubic B-spline, built in one package."""
    rng = np.random.default_rng(seed)
    pts = np.cumsum(rng.normal(size=(9, 3)), axis=0)
    return {"line": an.Line(np.array([2.0, 0.0, 0.0]), np.array([0.2, 0.1, 1.0])),
            "circle": an.Circle(an.make_frame((0, 0, 0), (0.1, 0.2, 1.0)), 1.5),
            "bspline": bs.fit_bspline_curve(pts, degree=3, n_ctrl=6)}


@pytest.mark.parametrize("kind", ["extruded", "revolved"])
@pytest.mark.parametrize("directrix", ["line", "circle", "bspline"])
def test_swept_eval_and_inverse(kind, directrix):
    """The sweeps, their forward grids and their ``_min_scan`` inverses."""
    surfs = []
    for an, bs, sw in ((j_an, j_bs, j_sw), (t_an, t_bs, t_sw)):
        c = _directrices(an, bs, 7)[directrix]
        if kind == "extruded":
            surfs.append(sw.make_extruded(c, np.array([0.3, -0.2, 2.0])))
        else:
            surfs.append(sw.make_revolved(c, an.make_frame((0.1, 0.0, 0.0), (0.0, 0.3, 1.0))))
    js, ts = surfs
    rng = np.random.default_rng(8)
    if kind == "extruded":
        lo, hi = (js.u0, js.u1) if np.isfinite(js.u0) else (-1.0, 1.0)
        u, v = rng.uniform(lo, hi, size=(4, 6)), rng.uniform(0, 1, size=(4, 6))
    else:
        lo, hi = (js.v0, js.v1) if np.isfinite(js.v0) else (-1.0, 1.0)
        u, v = rng.uniform(0, 2 * np.pi, size=(4, 6)), rng.uniform(lo, hi, size=(4, 6))
    p = js.eval(u, v)
    _eq(ts.eval(u, v), p)
    for got, want in zip(ts.uv_of(p), js.uv_of(p)):
        _eq(got, want)
    _eq(t_sw.curve_eval(ts.curve, u), j_sw.curve_eval(js.curve, u))
    assert t_sw.curve_domain(ts.curve) == j_sw.curve_domain(js.curve)


def test_min_scan_bit_equal():
    rng = np.random.default_rng(9)
    centers = rng.uniform(-2, 3, size=25)
    cost = lambda ts: np.cos(3 * ts) + (ts - centers[:, None]) ** 2
    for clamp in ((None, None), (-1.0, 2.0)):
        _eq(t_sw._min_scan(cost, -1.0, 2.0, 25, *clamp),
            j_sw._min_scan(cost, -1.0, 2.0, 25, *clamp))


def test_offsets_and_trims():
    """``make_offset`` reduces each analytic class in closed form and wraps
    free-form bases numerically; ``make_trimmed`` restricts free-form bases."""
    js, ts = _surfaces(j_an, 10), _surfaces(t_an, 10)
    u, v = np.meshgrid(np.linspace(0.1, 1.2, 5), np.linspace(-0.3, 0.4, 4), indexing="ij")
    for name in js:
        jo, to = j_sw.make_offset(js[name], 0.25), t_sw.make_offset(ts[name], 0.25)
        assert type(to).__name__ == type(jo).__name__ == type(js[name]).__name__
        _eq(to.eval(u, v), jo.eval(u, v))
        assert t_sw.make_trimmed(ts[name], 0, 1, 0, 1) is ts[name]
    for rational in (False, True):
        (jb, _), (tb, _) = _bspline_pair(11, rational)
        gu, gv = np.linspace(0.2, 0.8, 6), np.linspace(0.1, 0.9, 5)
        jo, to = j_sw.make_offset(jb, 0.1), t_sw.make_offset(tb, 0.1)
        assert to.domain() == jo.domain()
        _eq(to.eval_grid(gu, gv), jo.eval_grid(gu, gv))
        for jbase, tbase in ((jb, tb), (jo, to)):
            jt, tt = (j_sw.make_trimmed(jbase, 0.25, 0.75, 0.1, 0.6),
                      t_sw.make_trimmed(tbase, 0.25, 0.75, 0.1, 0.6))
            assert isinstance(tt, t_sw.TrimmedSurface) and tt.domain() == jt.domain()
            _eq(tt.eval_grid(gu, gv), jt.eval_grid(gu, gv))
    with pytest.raises(ValueError, match="unsupported OFFSET_SURFACE basis Line"):
        t_sw.make_offset(_curves(t_an, 0)["line"], 1.0)
