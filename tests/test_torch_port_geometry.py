"""Port: B-rep assembly, STL and STEP export against the JAX package.

The port's trimming cell helpers run in its native host library
(``geometry/native_bindings.py``, built with g++ at first use). The JAX
package takes its own native library when it is built, else its numpy
fallback; both reference paths are held against the port. The port's STEP
files must pass the JAX package's readers and conformance validator and the
port's own.
"""

import numpy as np
import pytest

from brepgen_tpu.data import synthetic
from brepgen_tpu.geometry import brep_build as j_brep_build
from brepgen_tpu.geometry import native_bindings
from brepgen_tpu.geometry.step_conformance import validate_step_file
from brepgen_tpu.geometry.step_reader import load_brep, validate_solid
from brepgen_tpu_torch.geometry import brep_build as t_brep_build
from brepgen_tpu_torch.geometry import native_bindings as t_native_bindings
from brepgen_tpu_torch.geometry import step_conformance as t_step_conformance
from brepgen_tpu_torch.geometry import step_reader as t_step_reader
from brepgen_tpu_torch.geometry import ply as t_ply
from brepgen_tpu_torch.geometry import stl as t_stl
from brepgen_tpu_torch.geometry.bspline import fit_bspline_curve, fit_bspline_surface
from brepgen_tpu_torch.geometry.sampling import sample_surface
from brepgen_tpu_torch.geometry.step_writer import write_step

SOLIDS = {
    "cuboid": synthetic.make_cuboid,
    "prism6": lambda: synthetic.make_prism(6),
    "cylinder": synthetic.make_cylinder,
    "lblock": synthetic.make_lblock,
    "frustum": synthetic.make_frustum,
}


@pytest.fixture(params=["numpy", "native"])
def reference_path(request, monkeypatch):
    """Which path the JAX package's trimming helpers take; the port's always
    take its native library."""
    if request.param == "numpy":
        monkeypatch.setattr(native_bindings, "_load", lambda: None)
    elif not native_bindings.native_available():
        pytest.skip("the JAX package's native host library is not built here")
    assert native_bindings.native_available() == (request.param == "native")
    assert t_native_bindings.load() is not None
    return request.param


def _area(tris):
    return 0.5 * float(np.linalg.norm(
        np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]), axis=1).sum())


def _build(mod, data):
    return mod.construct_brep(data["surf_wcs"], data["edge_wcs"], data["faceEdge_adj"],
                              data["edgeCorner_adj"])


@pytest.mark.parametrize("shape", sorted(SOLIDS))
def test_construct_brep_matches_jax(shape, reference_path, tmp_path):
    data = SOLIDS[shape]()
    want, got = _build(j_brep_build, data), _build(t_brep_build, data)
    assert got.face_loops == want.face_loops
    assert got.topology_ok() == want.topology_ok()
    if reference_path == "native":
        # native on both sides: the same function, the same triangles
        for w, g in zip(want.face_triangles, got.face_triangles):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
    else:
        # the port's native nearest-grid search breaks exact distance ties
        # (grid samples equidistant from a boundary point) the other way than
        # the JAX package's numpy argmin: a few boundary cells of the prism's
        # caps differ (1238 against 1250 triangles); the trimmed area agrees
        # within 2%
        for w, g in zip(want.face_triangles, got.face_triangles):
            assert abs(_area(g) - _area(w)) <= 0.02 * _area(w)
    np.testing.assert_array_equal(got.edge_vertex_adj, want.edge_vertex_adj)
    # STL and STEP: the same files from both packages
    for obj, tag in ((want, "jax"), (got, "torch")):
        obj.write_stl(str(tmp_path / f"{tag}.stl"))
        obj.write_step(str(tmp_path / f"{tag}.step"))
    if reference_path == "native":
        np.testing.assert_allclose(t_stl.read_stl(str(tmp_path / "torch.stl")),
                                   t_stl.read_stl(str(tmp_path / "jax.stl")), rtol=0, atol=1e-5)
    assert (tmp_path / "torch.step").read_text() == (tmp_path / "jax.step").read_text()


@pytest.mark.parametrize("shape", sorted(SOLIDS))
def test_step_export_passes_jax_validators(shape, tmp_path):
    data = SOLIDS[shape]()
    solid = _build(t_brep_build, data)
    assert solid.topology_ok()
    path = str(tmp_path / "solid.step")
    solid.write_step(path)
    assert "MANIFOLD_SOLID_BREP" in open(path).read()
    assert validate_step_file(path) == []
    assert t_step_conformance.validate_step_file(path) == []
    report = validate_solid(load_brep(path))
    assert report["ok"], report
    assert report["n_faces"] == len(data["surf_wcs"])
    assert report["n_edges"] == len(data["edge_wcs"])
    assert t_step_reader.validate_solid(t_step_reader.load_brep(path)) == report


def test_geometric_fallback_passes_jax_validator(tmp_path):
    gx, gy = np.meshgrid(np.linspace(0, 1, 8), np.linspace(0, 1, 8), indexing="ij")
    surf = fit_bspline_surface(np.stack([gx, gy, gx * gy], -1), n_ctrl=6)
    curve = fit_bspline_curve(np.stack([np.linspace(0, 1, 8), np.zeros(8), np.zeros(8)], -1))
    path = str(tmp_path / "g.step")
    write_step(path, [surf], [curve])
    assert "GEOMETRIC_SET" in open(path).read()
    assert validate_step_file(path) == []
    assert t_step_conformance.validate_step_file(path) == []


def test_nonsolid_topology_degrades_to_geometric_set(tmp_path):
    """An edge used by one face only: not a closed shell, so ``write_step``
    exports loose geometry, which still passes the validator."""
    data = synthetic.make_cuboid()
    adj = [list(a) for a in data["faceEdge_adj"]]
    adj[0] = adj[0][:-1]
    solid = t_brep_build.construct_brep(data["surf_wcs"], data["edge_wcs"], adj,
                                        data["edgeCorner_adj"])
    assert not solid.topology_ok()
    path = str(tmp_path / "open.step")
    solid.write_step(path)
    text = open(path).read()
    assert "GEOMETRIC_SET" in text and "MANIFOLD_SOLID_BREP" not in text
    assert validate_step_file(path) == []
    assert t_step_conformance.validate_step_file(path) == []


def test_stl_ply_and_sampling_round_trip(tmp_path):
    from brepgen_tpu.geometry.sampling import sample_surface as j_sample_surface

    tris = _build(t_brep_build, synthetic.make_cylinder()).triangles()
    t_stl.write_stl(str(tmp_path / "c.stl"), tris)
    back = t_stl.read_stl(str(tmp_path / "c.stl"))
    np.testing.assert_allclose(back, tris, rtol=0, atol=1e-6)
    got = sample_surface(back, 2000, np.random.default_rng(3))
    want = j_sample_surface(back, 2000, np.random.default_rng(3))
    np.testing.assert_array_equal(got, want)
    t_ply.write_ply(str(tmp_path / "c.ply"), got)
    np.testing.assert_allclose(t_ply.read_ply(str(tmp_path / "c.ply")), got, rtol=0, atol=1e-6)
