"""Port: the native host geometry library (``geometry/native_bindings.py``,
``geometry/native/brepnative.cpp``) against the JAX package's library and
against the port's numpy versions.

The port builds its library with ``-ffp-contract=off`` and no
``-march=native``; the JAX package's Makefile builds with ``-march=native``,
which on a host with FMA lets the compiler fuse ``a + u*(b-a) + v*(c-a)`` in
``sample_triangles``. So the JAX package's source built with the port's
flags is held to the port's library bit for bit, and the JAX package's own
build to it exactly in every entry but that one, which differs by the
rounding of a fused multiply-add: within 4 ulps of the coordinates'
magnitude.
"""

import ctypes
import os
from pathlib import Path

import numpy as np
import pytest

from brepgen_tpu.data import synthetic
from brepgen_tpu.geometry import brep_build as j_brep_build
from brepgen_tpu.geometry import native_bindings as j_nb
from brepgen_tpu_torch.geometry import brep_build as t_brep_build
from brepgen_tpu_torch.geometry import native_bindings as t_nb

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
JAX_SOURCE = os.path.join(ROOT, "brepgen_tpu", "geometry", "native", "brepnative.cpp")


def _inputs(seed):
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 2 * np.pi, 40, endpoint=False)
    r = 10 + 4 * np.sin(5 * t) + rng.uniform(-0.5, 0.5, size=40)
    star = np.stack([15 + r * np.cos(t), 15 + r * np.sin(t)], -1)
    hole = np.array([[10, 10], [10, 20], [20, 20], [20, 10]], float) + rng.uniform(-1, 1)
    grid = rng.normal(size=(16, 12, 3))
    pts = grid.reshape(-1, 3)[rng.integers(0, 192, 30)] + rng.normal(scale=1e-3, size=(30, 3))
    return dict(polys=[star, hole], grid=grid, pts=pts, inside=rng.random((15, 11)) > 0.5,
                tris=rng.normal(size=(60, 3, 3)), a=rng.normal(size=(50, 3)),
                b=rng.normal(size=(70, 3)))


def _call_all(mod, x):
    return dict(
        cells=mod.cells_inside_polygons(x["polys"], 32, 32),
        nearest=mod.nearest_grid_index(x["pts"], x["grid"]),
        tess=mod.tessellate_cells(x["grid"], x["inside"]),
        samples=mod.sample_triangles(x["tris"], 500, seed=3),
        chamfer=mod.chamfer_one_directional(x["a"], x["b"]),
    )


@pytest.fixture(scope="module")
def jax_native():
    if not j_nb.native_available():
        pytest.skip("the JAX package's native host library is not built here")
    return j_nb


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_entries_equal_jax_native(jax_native, seed):
    x = _inputs(seed)
    got, want = _call_all(t_nb, x), _call_all(jax_native, x)
    for k in ("cells", "nearest", "tess"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["chamfer"] == want["chamfer"]
    ulp = np.finfo(np.float64).eps * np.abs(x["tris"]).max()
    np.testing.assert_allclose(got["samples"], want["samples"], rtol=0, atol=4 * ulp)


def test_jax_source_with_port_flags_is_bit_equal(tmp_path, monkeypatch):
    """The JAX package's C++ and the port's copy are the same function: the
    former, built with the port's flags, gives every entry bit for bit."""
    got = {s: _call_all(t_nb, _inputs(s)) for s in (0, 1)}
    monkeypatch.setattr(t_nb, "SOURCE", Path(JAX_SOURCE))
    monkeypatch.setenv("BREPGEN_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(t_nb, "_lib", t_nb._bind(ctypes.CDLL(str(t_nb.build()))))
    assert str(tmp_path) in t_nb.load()._name
    for s, g in got.items():
        want = _call_all(t_nb, _inputs(s))
        for k in want:
            assert type(g[k]) is type(want[k])
            np.testing.assert_array_equal(g[k], want[k], err_msg=k)


def test_entries_against_numpy_versions():
    """As ``tests/test_native.py``: containment, nearest index (off ties) and
    chamfer as the numpy versions; triangles as many as inside cells, each
    cell's corners; samples on their triangle."""
    x = _inputs(4)
    np.testing.assert_array_equal(t_nb.cells_inside_polygons(x["polys"], 32, 32),
                                  t_nb.cells_inside_polygons_np(x["polys"], 32, 32))
    inside = t_nb.cells_inside_polygons(x["polys"], 32, 32)
    assert inside[6, 6] and not inside[15, 15]  # the hole, carved by even-odd
    np.testing.assert_array_equal(t_nb.nearest_grid_index(x["pts"], x["grid"]),
                                  t_nb.nearest_grid_index_np(x["pts"], x["grid"]))
    tris = t_nb.tessellate_cells(x["grid"], x["inside"])
    np.testing.assert_array_equal(tris, t_nb.tessellate_cells_np(x["grid"], x["inside"]))
    assert tris.shape == (2 * x["inside"].sum(), 3, 3)
    one = np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]], float)
    pts = t_nb.sample_triangles(one, 500, seed=3)
    assert pts.shape == (500, 3) and np.all(pts[:, 2] == 0)
    assert np.all(pts[:, :2] >= 0) and np.all(pts[:, 0] + pts[:, 1] <= 1.0 + 1e-12)
    assert t_nb.sample_triangles_np(one, 500, seed=3).shape == (500, 3)
    np.testing.assert_allclose(t_nb.chamfer_one_directional(x["a"], x["b"]),
                               t_nb.chamfer_one_directional_np(x["a"], x["b"]), rtol=1e-12)
    assert t_nb.cells_inside_polygons([], 5, 4).shape == (4, 3)


def test_distance_ties_on_the_prism_caps(jax_native):
    """Boundary points equidistant from two grid samples: both native
    libraries keep the first, the numpy argmin of the expanded distance
    another; the hexagonal caps get 1238 triangles natively, 1250 on the
    JAX package's numpy path."""
    data = synthetic.make_prism(6)
    args = (data["surf_wcs"], data["edge_wcs"], data["faceEdge_adj"], data["edgeCorner_adj"])
    port = t_brep_build.construct_brep(*args).face_triangles
    jax = j_brep_build.construct_brep(*args).face_triangles
    assert [len(t) for t in port[:2]] == [len(t) for t in jax[:2]] == [1238, 1238]
    for g, w in zip(port, jax):
        np.testing.assert_array_equal(g, w)
    lib, tried = j_nb._lib, j_nb._tried
    j_nb._lib, j_nb._tried = None, True
    try:
        numpy_caps = j_brep_build.construct_brep(*args).face_triangles[:2]
    finally:
        j_nb._lib, j_nb._tried = lib, tried
    assert [len(t) for t in numpy_caps] == [1250, 1250]


def test_build_is_keyed_and_raises_with_the_compiler_message(tmp_path, monkeypatch):
    monkeypatch.setenv("BREPGEN_TORCH_BUILD_DIR", str(tmp_path))
    first = t_nb.build()
    assert first.is_file() and first.parent.parent == tmp_path
    assert t_nb.build() == first  # reused, not rebuilt
    broken = tmp_path / "broken.cpp"
    broken.write_text('extern "C" int f( { return 0; }\n')
    monkeypatch.setattr(t_nb, "SOURCE", broken)
    with pytest.raises(RuntimeError, match="failed to build .*broken.cpp(.|\n)*error"):
        t_nb.build()
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="no-such-compiler' not found"):
        t_nb.build()
