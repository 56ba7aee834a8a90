"""Port, the whole slice on the CPU: a tiny cascade through the port's sample
CLI (recovery on) writes STEP/STL and the raw dump; the JAX package's
``process_one`` on the same dump gives the same per-sample outcome; the
port's eval CLI samples point clouds and scores them, as the JAX protocol
does on the same folders."""

import ast
import os

import numpy as np
import pytest
import torch

from brepgen_tpu.cli.sample_main import make_padded_decoder as j_make_padded_decoder
from brepgen_tpu.cli.sample_main import process_one as j_process_one
from brepgen_tpu.eval.pipeline import run_metrics as j_run_metrics
from brepgen_tpu.nn import EdgeVAE as JEdgeVAE
from brepgen_tpu.nn import SurfVAE as JSurfVAE
from brepgen_tpu.train.checkpoint import load_params
from brepgen_tpu.train.vae_train import make_decoder_fn
from brepgen_tpu_torch.cli import eval_main, sample_main
from brepgen_tpu_torch.cli.build import ARCHS
from brepgen_tpu_torch.sampling import cascade

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
PACKS = os.path.join(ROOT, "artifacts", "demo_round5", "all160k", "ckpt_packed")
BATCH = 4


def _jax_decoders():
    sv = JSurfVAE(block_out_channels=ARCHS["demo"]["surface"])
    ev = JEdgeVAE(block_out_channels=ARCHS["demo"]["edge"])
    return (j_make_padded_decoder(make_decoder_fn(sv), load_params(
                os.path.join(PACKS, "surf_vae.npz")), (4, 4, 3)),
            j_make_padded_decoder(make_decoder_fn(ev), load_params(
                os.path.join(PACKS, "edge_vae.npz")), (4, 3)))


def _outcome(result):
    """(valid, note or failure key) of one ``process_one`` result."""
    name, note = result
    return (name is not None, note if name is not None else note.split(":")[0])


@pytest.fixture(scope="module")
def sampled(tmp_path_factory):
    """One batch of 4 at 10 face slots x 8 edges, DDIM 20, all160k packs."""
    out = tmp_path_factory.mktemp("samples")
    mp = pytest.MonkeyPatch()
    mp.setitem(cascade.MODE_PRESETS, "deepcad", dict(num_surfaces=5, num_edges=8, use_cf=False))
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        sample_main.main([
            "--mode", "deepcad", "--weights_dir", PACKS, "--batch_size", str(BATCH),
            "--max_batches", "1", "--fast_steps", "20", "--device", "cpu",
            "--workers", "2", "--save_folder", str(out),
        ])
    finally:
        torch.set_num_threads(threads)
        mp.undo()
    return out


def test_cli_outcomes_match_jax_process_one(sampled, tmp_path):
    with np.load(sampled / "batches.npz") as raw:
        batch = {k.rsplit("__", 1)[0]: raw[k] for k in raw.files}
    assert batch["surf_z"].shape == (BATCH, 10, 48)
    t_decoders = sample_main.host_decoders(sample_main.init_cascade(
        "deepcad", PACKS, batch_size=BATCH, device="cpu"))
    j_decoders = _jax_decoders()
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    got, want = [], []
    for b in range(BATCH):
        got.append(_outcome(sample_main.process_one(
            batch, b, *t_decoders, 0.2, str(tmp_path / "t"), recovery=True, device="cpu")))
        want.append(_outcome(j_process_one(
            batch, b, *j_decoders, 0.2, str(tmp_path / "j"), recovery=True)))
    assert got == want
    valid = sum(v for v, _ in got)
    assert valid >= 1
    # the CLI run wrote one STEP and one STL per valid sample
    for suffix in (".step", ".stl"):
        assert len([f for f in os.listdir(sampled) if f.endswith(suffix)]) == valid
    assert len([f for f in os.listdir(tmp_path / "j") if f.endswith(".stl")]) == valid


def test_eval_cli_scores_the_samples_as_jax(sampled, tmp_path):
    """STL -> 2000-point PLY through ``eval_main sample_points``, then
    ``eval_main pc_metric`` against clouds of the synthetic cuboid family."""
    from brepgen_tpu.data.synthetic import make_dataset
    from brepgen_tpu_torch.geometry import construct_brep

    real_stl = tmp_path / "real_stl"
    real_stl.mkdir()
    for i, d in enumerate(make_dataset(5, seed=0)):
        construct_brep(d["surf_wcs"], d["edge_wcs"], d["faceEdge_adj"],
                       d["edgeCorner_adj"]).write_stl(str(real_stl / f"{i}.stl"))
    fake_ply, real_ply = tmp_path / "fake_ply", tmp_path / "real_ply"
    eval_main.main(["sample_points", "--in_dir", str(sampled), "--out_dir", str(fake_ply)])
    eval_main.main(["sample_points", "--in_dir", str(real_stl), "--out_dir", str(real_ply)])
    n_fake = len(os.listdir(fake_ply))
    assert n_fake >= 1 and len(os.listdir(real_ply)) == 5
    args = ["--n_test", "5", "--multi", "1", "--times", "2", "--seed", "3"]
    eval_main.main(["pc_metric", "--fake", str(fake_ply), "--real", str(real_ply),
                    "--device", "cpu", *args])
    lines = (tmp_path / "fake_ply_results.txt").read_text().splitlines()
    assert len(lines) == 3
    got = ast.literal_eval(lines[-1])
    want = j_run_metrics(str(fake_ply), str(real_ply), n_test=5, multi=1, times=2, seed=3,
                         output=str(tmp_path / "j.txt"))
    assert abs(got["avg-MMD-CD"] - want["avg-MMD-CD"]) <= 1e-6
    assert got["avg-COV-CD"] == want["avg-COV-CD"]
    assert got["avg-JSD"] == want["avg-JSD"]
    assert all(np.isfinite(v) for v in got.values())

