"""Port: host postprocess (vertex merge, edge pairing with the recovery
ladder, joint optimization) against the JAX package on the CPU.

Topology, recovery rungs and the analytic edge geometry must be identical.
The face offsets come from 200 AdamW steps in each framework: the two round
differently, and Adam scales a gradient that is pure rounding noise (a
component whose true gradient is zero, e.g. a planar face whose boundary
lies in its plane, or the flat region near the optimum) to a step of up to
about lr = 1e-3. Measured: offsets agree to 1e-6 on most inputs and drift up
to 6.0e-3 on the worst of twelve random seeds (5.3e-4 on the pentagonal
prism), while the loss they reach agrees to 1.6e-4 relative. The
tolerances below are set from those measurements.
"""

import numpy as np
import pytest
import torch

from brepgen_tpu.data.synthetic import make_cuboid, make_prism
from brepgen_tpu.postprocess import edge_merge as j_edge_merge
from brepgen_tpu.postprocess import joint_opt as j_joint_opt
from brepgen_tpu.postprocess.pipeline import postprocess_single as j_postprocess
from brepgen_tpu.postprocess.vertex_merge import PostprocessError as JPostprocessError
from brepgen_tpu_torch.postprocess import edge_merge as t_edge_merge
from brepgen_tpu_torch.postprocess import joint_opt as t_joint_opt
from brepgen_tpu_torch.postprocess.pipeline import make_padded_decoder
from brepgen_tpu_torch.postprocess.pipeline import postprocess_single as t_postprocess
from brepgen_tpu_torch.postprocess.vertex_merge import PostprocessError as TPostprocessError
from test_postprocess import _two_vertex_setup, cascade_arrays_from_sample

SURF_TOL = 2e-3      # surf_wcs, abs: two AdamW steps of lr 1e-3 (see above)
OFFSET_TOL = 1e-2    # offsets on random inputs, abs (worst measured 6.0e-3)
LOSS_RTOL = 1e-3     # final loss, relative (worst measured 1.6e-4)
MAKERS = {"cuboid": make_cuboid, "prism5": lambda: make_prism(5)}


def _assert_same_brep(a, b):
    assert a.face_edge_adj == b.face_edge_adj
    np.testing.assert_array_equal(a.edge_vertex_adj, b.edge_vertex_adj)
    assert a.recovery_rung == b.recovery_rung
    np.testing.assert_allclose(b.unique_vertices, a.unique_vertices, rtol=0, atol=1e-12)
    np.testing.assert_allclose(b.edge_wcs, a.edge_wcs, rtol=0, atol=1e-6)
    np.testing.assert_allclose(b.surf_wcs, a.surf_wcs, rtol=0, atol=SURF_TOL)


@pytest.mark.parametrize("recovery", [False, True], ids=["strict", "recovery"])
@pytest.mark.parametrize("shape", sorted(MAKERS))
def test_postprocess_matches_jax(shape, recovery):
    sample, surf_decode, edge_decode = cascade_arrays_from_sample(MAKERS[shape]())
    want = j_postprocess(sample, 0, surf_decode, edge_decode, recovery=recovery)
    got = t_postprocess(sample, 0, surf_decode, edge_decode, recovery=recovery, device="cpu")
    assert got.recovery_rung == 0
    _assert_same_brep(want, got)


@pytest.mark.parametrize("shape", sorted(MAKERS))
def test_perturbed_sample_reaches_a_rung_in_both(shape):
    """One duplicate of one edge gets latents 0.275 (mean abs) from its
    mate: over the 0.2 threshold, under 2.5x it. Strict pairing rejects the
    sample in both packages; recovery re-pairs it at rung 2 in both."""
    sample, surf_decode, edge_decode = cascade_arrays_from_sample(MAKERS[shape]())
    sample["edge_z"] = sample["edge_z"].copy()
    sample["edge_z"][0, 0, 0, 1:] += 0.3  # component 0 carries the decode id
    with pytest.raises(JPostprocessError) as j_err:
        j_postprocess(sample, 0, surf_decode, edge_decode)
    with pytest.raises(TPostprocessError) as t_err:
        t_postprocess(sample, 0, surf_decode, edge_decode, device="cpu")
    assert str(t_err.value) == str(j_err.value)
    want = j_postprocess(sample, 0, surf_decode, edge_decode, recovery=True)
    got = t_postprocess(sample, 0, surf_decode, edge_decode, recovery=True, device="cpu")
    assert got.recovery_rung == want.recovery_rung == 2
    _assert_same_brep(want, got)


LADDER_CASES = {
    # 4 mutually similar edges: rung 1 (greedy min-z matching)
    "rung1": lambda: (*_two_vertex_setup(4),
                      np.array([0.0, 0.05, 0.10, 0.15])[:, None] * np.ones((4, 12)),
                      np.zeros((2, 2), bool)),
    # a pair 0.3 apart: rung 2 (2.5x threshold)
    "rung2": lambda: (*_two_vertex_setup(2), np.array([0.0, 0.3])[:, None] * np.ones((2, 12)),
                      np.zeros((1, 2), bool)),
    # an unpairable closed stray: rung 4 drop
    "rung4": lambda: (np.array([[0, 0, 0], [1, 0, 0], [2, 0, 0]], float),
                      {0: [0, 2, 6, 8], 1: [1, 3, 7, 9], 2: [4, 5]},
                      np.array([0.0, 0.01, 0.9, 0.3, 0.31])[:, None] * np.ones((5, 12)),
                      np.array([[False, False, False], [False, False, True]])),
}


@pytest.mark.parametrize("case", sorted(LADDER_CASES))
def test_recovery_ladder_matches_jax(case):
    verts, groups, z, mask = LADDER_CASES[case]()
    surf_z = np.zeros((len(mask), 48))
    outs = []
    for mod in (j_edge_merge, t_edge_merge):
        info = {}
        out = mod.detect_shared_edge(verts.copy(), groups, z, surf_z, 0.2, mask,
                                     recovery=True, info=info)
        outs.append((out, {k: v for k, v in info.items() if k not in ("vsets", "ranges")}))
    (j_out, j_info), (t_out, t_info) = outs
    assert t_info == j_info and t_info["recovery_rung"] == int(case[-1])
    np.testing.assert_array_equal(t_out[1], j_out[1])
    assert t_out[2] == j_out[2]
    np.testing.assert_array_equal(t_out[3], j_out[3])


def _offset_inputs(seed, F=5, E=96):
    rng = np.random.default_rng(seed)
    surf = rng.normal(size=(F, 32, 32, 3)).astype(np.float32)
    epts = (rng.normal(size=(F, E, 3)) + 0.3).astype(np.float32)
    valid = (rng.random((F, E)) < 0.8).astype(np.float32)
    return surf, epts, valid


def _loss(surf, epts, valid, offsets):
    moved = surf.reshape(len(surf), -1, 3).astype(np.float64) + offsets[:, None]
    d2 = ((epts[:, :, None].astype(np.float64) - moved[:, None]) ** 2).sum(-1)
    return float((d2.min(-1) * valid).sum() / len(surf))


@pytest.mark.parametrize("seed", range(6))
def test_surface_offsets_match_jax(seed):
    surf, epts, valid = _offset_inputs(seed)
    want = j_joint_opt._optimize_surface_offsets(surf, epts, valid)
    got = t_joint_opt._optimize_surface_offsets(surf, epts, valid, "cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=OFFSET_TOL)
    start = _loss(surf, epts, valid, np.zeros((len(surf), 3)))
    l_want, l_got = _loss(surf, epts, valid, want), _loss(surf, epts, valid, got)
    assert l_want < start and l_got < start
    assert abs(l_got - l_want) <= LOSS_RTOL * l_want


def test_padded_decoder_pads_to_powers_of_two():
    seen = []

    def decode(z):
        seen.append((z.shape[0], torch.is_grad_enabled()))
        return z.reshape(len(z), -1) * 2.0

    dec = make_padded_decoder(decode, (4, 3), "cpu")
    z = np.arange(5 * 12, dtype=np.float32).reshape(5, 12)
    np.testing.assert_array_equal(dec(z), z * 2.0)
    dec(z[:1])
    dec(z[:2])
    assert seen == [(8, False), (2, False), (2, False)]
