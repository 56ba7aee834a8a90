"""Port: stands alone from JAX, refuses to fall back to the CPU, and its CLI
writes the raw batches and the solids."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import brepgen_tpu_torch
from brepgen_tpu_torch.cli import sample_main
from brepgen_tpu_torch.sampling import cascade

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
PACKAGE = os.path.join(ROOT, "brepgen_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "brepgen_tpu")
PACKS = os.path.join(ROOT, "artifacts", "demo_round5", "all160k", "ckpt_packed")


def test_import_leaves_jax_out():
    code = (
        "import sys, brepgen_tpu_torch, brepgen_tpu_torch.cli.sample_main, "
        "brepgen_tpu_torch.cli.eval_main, brepgen_tpu_torch.kernels.attention, "
        "brepgen_tpu_torch.kernels.chamfer, brepgen_tpu_torch.postprocess, "
        "brepgen_tpu_torch.geometry, brepgen_tpu_torch.eval, brepgen_tpu_torch.data.augment, "
        "brepgen_tpu_torch.cli.ldm_main, brepgen_tpu_torch.train.ldm_train, "
        "brepgen_tpu_torch.train.vae_train, brepgen_tpu_torch.train.checkpoint, "
        "brepgen_tpu_torch.train.loop, brepgen_tpu_torch.data.loader, "
        "brepgen_tpu_torch.data.schema, brepgen_tpu_torch.data.synthetic, "
        "brepgen_tpu_torch.kernels.set_attention, brepgen_tpu_torch.cli.vae_main, "
        "brepgen_tpu_torch.cli.process_main, brepgen_tpu_torch.data.dedup, "
        "brepgen_tpu_torch.data.discovery, brepgen_tpu_torch.data.latent_cache, "
        "brepgen_tpu_torch.utils.profiling, brepgen_tpu_torch.geometry.step_reader, "
        "brepgen_tpu_torch.geometry.step_conformance, brepgen_tpu_torch.geometry.analytic, "
        "brepgen_tpu_torch.geometry.swept, brepgen_tpu_torch.geometry.native_extract, "
        "brepgen_tpu_torch.geometry.native_bindings, brepgen_tpu_torch.cli.shard_driver, "
        "brepgen_tpu_torch.parallel, brepgen_tpu_torch.parallel.distributed, "
        "brepgen_tpu_torch.parallel.mesh, brepgen_tpu_torch.parallel.sharding_rules, "
        "brepgen_tpu_torch.tools.convert_torch, brepgen_tpu_torch.utils.viz\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, check=True)


def _sources():
    for dirpath, _, files in os.walk(PACKAGE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, ROOT))
def test_source_imports_nothing_of_jax(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"


def test_entry_point_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        brepgen_tpu_torch.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sample_main.init_cascade("deepcad", batch_size=1)
    assert brepgen_tpu_torch.resolve_device("cpu") == torch.device("cpu")


def test_cli_writes_raw_batches(tmp_path, monkeypatch):
    # the deepcad preset shrunk to 4 faces x 3 edges keeps the run short on
    # a loaded CPU; one thread avoids oversubscribing it
    monkeypatch.setitem(cascade.MODE_PRESETS, "deepcad",
                        dict(num_surfaces=4, num_edges=3, use_cf=False))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        sample_main.main([
            "--mode", "deepcad", "--weights_dir", PACKS, "--batch_size", "2",
            "--max_batches", "2", "--fast_steps", "4", "--device", "cpu",
            "--save_folder", str(tmp_path),
        ])
    finally:
        torch.set_num_threads(threads)
    keys = ("surf_pos", "surf_mask", "surf_z", "surf_ncs", "edge_pos", "edge_mask", "edge_z",
            "edge_v", "edge_ncs")
    with np.load(tmp_path / "batches.npz") as out:
        assert sorted(out.files) == sorted(f"{k}__{b}" for k in keys for b in (0, 1))
        assert out["edge_ncs__1"].shape == (2, 8, 3, 32, 3)
        assert np.isfinite(out["edge_ncs__1"]).all()
        assert not out["surf_mask__0"][:, 0].any()
        assert not np.array_equal(out["surf_pos__0"], out["surf_pos__1"])


class _FixedCascade:
    """Stands in for ``Cascade``: every batch holds the synthetic cuboid in
    slot 0 and, in slot 1, the same cuboid with one edge's latents moved off
    its mate, which the strict postprocess rejects."""

    def __init__(self):
        from brepgen_tpu.data.synthetic import make_cuboid
        from test_postprocess import cascade_arrays_from_sample

        data = make_cuboid()
        one, _, _ = cascade_arrays_from_sample(data)
        bad = {k: v.copy() for k, v in one.items()}
        bad["edge_z"][0, 0, 0, 1:] += 0.3
        self.sample = {k: torch.from_numpy(np.concatenate([one[k], bad[k]])) for k in one}
        lookup = lambda table: lambda z: torch.from_numpy(
            table[np.round(z.reshape(len(z), -1)[:, 0].numpy() * 10).astype(int)])
        self.surf_vae = type("V", (), {"decode": staticmethod(lookup(data["surf_ncs"]))})()
        self.edge_vae = type("V", (), {"decode": staticmethod(lookup(data["edge_ncs"]))})()
        self.cfg = cascade.CascadeConfig(batch_size=2)
        self.device = torch.device("cpu")

    def __call__(self, noise, stage_times=None, after_stage=None):
        return self.sample


def test_num_samples_counts_valid_breps(tmp_path):
    """``--num_samples N`` stops after N valid B-reps, not N raw samples:
    with one valid sample per strict batch, 3 need at least 3 batches."""
    run = sample_main.sample_loop(_FixedCascade(), num_samples=3, save_folder=str(tmp_path),
                                  recovery=False, workers=2)
    assert run.produced >= 3 and len(run.batches) >= 3
    assert run.attempted == 2 * len(run.batches)
    assert run.strict == run.solid == run.produced == len(run.batches)
    assert run.failures == {"postprocess failed": len(run.batches)}
    assert len([f for f in os.listdir(tmp_path) if f.endswith(".step")]) == run.produced
    # with recovery every sample is valid; slot 1 is rescued at rung 2
    run = sample_main.sample_loop(_FixedCascade(), num_samples=3, save_folder=str(tmp_path),
                                  workers=2)
    assert run.produced == run.attempted >= 3 and not run.failures
    assert run.rungs == {"recovered: rung 2": run.produced - run.strict}
