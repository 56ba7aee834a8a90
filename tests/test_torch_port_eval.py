"""Port: the Chamfer matrix (plain version of kernel K4) and the
JSD / MMD-CD / COV-CD protocol against the JAX package on the CPU."""

import numpy as np
import pytest
import torch

from brepgen_tpu.eval import metrics as j_metrics
from brepgen_tpu.eval import pipeline as j_pipeline
from brepgen_tpu.kernels.chamfer import chamfer_matrix as j_chamfer_pallas
from brepgen_tpu_torch.eval import metrics as t_metrics
from brepgen_tpu_torch.eval import pipeline as t_pipeline
from brepgen_tpu_torch.geometry.ply import write_ply
from brepgen_tpu_torch.kernels import LAUNCH_COUNTS
from brepgen_tpu_torch.kernels.chamfer import (
    PLAIN_SLAB,
    chamfer_matrix,
    chamfer_matrix_reference,
)

CHAMFER_ATOL = 1e-6


def _clouds(n, P, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=(n, P, 3)) * scale).astype(np.float32)


@pytest.mark.parametrize("S,R,P", [(5, 3, 40), (7, 4, 33), (1, 6, 1), (3, 1, 64)])
def test_plain_chamfer_matches_jax(S, R, P):
    sp, rp = _clouds(S, P, seed=S), _clouds(R, P, seed=100 + R)
    got = chamfer_matrix(torch.from_numpy(sp), torch.from_numpy(rp)).numpy()
    want_xla = j_metrics.pairwise_chamfer(sp, rp, block=2, backend="xla")
    np.testing.assert_allclose(got, want_xla, rtol=0, atol=CHAMFER_ATOL)
    want_pallas = np.asarray(j_chamfer_pallas(sp, rp, block_s=4, block_r=2, chunk=16,
                                              interpret=True))
    np.testing.assert_allclose(got, want_pallas, rtol=0, atol=CHAMFER_ATOL)


def test_padded_points_are_excluded():
    """The first n of P points count; padding holds garbage that must not."""
    sp, rp = _clouds(4, 30, seed=1), _clouds(3, 30, seed=2)
    sp[:, 21:] = 1e3
    rp[:, 21:] = -1e3
    got = chamfer_matrix(torch.from_numpy(sp), torch.from_numpy(rp), n_pts=21).numpy()
    want = j_metrics.pairwise_chamfer(sp[:, :21], rp[:, :21], backend="xla")
    np.testing.assert_allclose(got, want, rtol=0, atol=CHAMFER_ATOL)


def test_plain_chamfer_blocks_agree_with_one_block(monkeypatch):
    """A slab budget that forces pair blocks and point chunks gives the same
    matrix as one block, up to f32 sums taken in another order."""
    sp, rp = _clouds(6, 50, seed=3), _clouds(5, 50, seed=4)
    whole = chamfer_matrix_reference(torch.from_numpy(sp), torch.from_numpy(rp))
    monkeypatch.setitem(PLAIN_SLAB, "cpu", 50 * 7)
    blocked = chamfer_matrix_reference(torch.from_numpy(sp), torch.from_numpy(rp))
    np.testing.assert_allclose(blocked.numpy(), whole.numpy(), rtol=1e-6, atol=0)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    before = LAUNCH_COUNTS["chamfer"]
    sp, rp = _clouds(2, 8, seed=5), _clouds(2, 8, seed=6)
    out = t_metrics.pairwise_chamfer(sp, rp, device="cpu")
    assert out.shape == (2, 2) and out.dtype == np.float32
    assert LAUNCH_COUNTS["chamfer"] == before
    with pytest.raises(ValueError):
        chamfer_matrix(torch.zeros(2, 8, 3), torch.zeros(2, 9, 3))
    with pytest.raises(ValueError):
        chamfer_matrix(torch.zeros(2, 8, 3), torch.zeros(2, 8, 3), n_pts=0)


def test_cov_mmd_and_jsd_match_jax():
    sp, rp = _clouds(12, 64, seed=7, scale=0.4), _clouds(5, 64, seed=8, scale=0.4)
    d_t = t_metrics.pairwise_chamfer(sp, rp, device="cpu")
    d_j = j_metrics.pairwise_chamfer(sp, rp, backend="xla")
    np.testing.assert_allclose(d_t, d_j, rtol=0, atol=CHAMFER_ATOL)
    # each package's MMD and COV from its own single matrix
    got = t_metrics.cov_mmd_from_matrix(d_t)
    want = {"MMD-CD": float(d_j.min(axis=0).mean()),
            "COV-CD": len(np.unique(np.argmin(d_j, axis=1))) / d_j.shape[1]}
    assert got["COV-CD"] == want["COV-CD"]
    assert abs(got["MMD-CD"] - want["MMD-CD"]) <= CHAMFER_ATOL
    assert (t_metrics.jsd_between_point_cloud_sets(sp, rp)
            == j_metrics.jsd_between_point_cloud_sets(sp, rp))
    pc = _clouds(1, 100, seed=9)[0] * 3 + 1
    np.testing.assert_array_equal(t_metrics.normalize_pc(pc), j_metrics.normalize_pc(pc))


def _write_clouds(folder, clouds):
    folder.mkdir()
    for i, pc in enumerate(clouds):
        write_ply(str(folder / f"{i:03d}.ply"), pc)


def test_run_metrics_matches_jax(tmp_path):
    """Same PLY folders and seed: the same clouds are drawn (more points
    than the protocol's 2000 in some files, so random.sample runs), and the
    metrics agree."""
    rng = np.random.default_rng(10)
    fake = [rng.normal(size=(2000 + 37 * (i % 2), 3)) * 0.5 for i in range(9)]
    real = [rng.normal(size=(2000, 3)) * 0.5 + 0.05 for _ in range(6)]
    _write_clouds(tmp_path / "fake", fake)
    _write_clouds(tmp_path / "real", real)
    kw = dict(n_test=4, multi=2, times=3, seed=11)
    got = t_pipeline.run_metrics(str(tmp_path / "fake"), str(tmp_path / "real"),
                                 output=str(tmp_path / "t.txt"), device="cpu", **kw)
    want = j_pipeline.run_metrics(str(tmp_path / "fake"), str(tmp_path / "real"),
                                  output=str(tmp_path / "j.txt"), **kw)
    assert set(got) == set(want) == {"avg-MMD-CD", "avg-COV-CD", "avg-JSD"}
    assert abs(got["avg-MMD-CD"] - want["avg-MMD-CD"]) <= 1e-6
    assert got["avg-COV-CD"] == want["avg-COV-CD"]
    assert got["avg-JSD"] == want["avg-JSD"]
    assert len((tmp_path / "t.txt").read_text().splitlines()) == 4
