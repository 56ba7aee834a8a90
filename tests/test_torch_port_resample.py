"""Port: the re-score entries on the CPU. ``cli/metrics_main.py`` draws the
held-out clouds byte for byte as ``scripts/demo_metrics.py:67-117`` does with
the JAX package; ``cli/resample_main.py`` samples the all160k packs at their
training size, and a strict replay of its dump tallies each setting as the
JAX package's ``process_one`` does on the same dump (the replay is host code
on the same numbers, so the tallies are equal, not close); a tiny resample
then scores through the metrics entry."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from brepgen_tpu.cli.sample_main import process_one as j_process_one
from brepgen_tpu.data import synthetic as j_synthetic
from brepgen_tpu.geometry.ply import write_ply as j_write_ply
from brepgen_tpu.geometry.sampling import sample_surface as j_sample_surface
from brepgen_tpu_torch.cli import metrics_main, resample_main
from test_torch_port_slice import PACKS, ROOT, _jax_decoders

BATCH, STEPS = 4, 20  # the CPU run's batch and DDIM steps (the CLI's: 16, the protocol)


def _jax_heldout(out_dir, n, seed, family="all", kind=None):
    """``demo_metrics.py:heldout_clouds`` on the JAX package's modules."""
    os.makedirs(out_dir)
    if kind == "prism":
        rng0 = np.random.default_rng(seed)
        ds = [j_synthetic.make_prism(int(rng0.integers(3, 8)), rng0.uniform(0.5, 1.5),
                                     rng0.uniform(0.4, 2.0), uid=f"h{i}") for i in range(n)]
    else:
        ds = j_synthetic.make_dataset(n, seed=seed, family=family)
    rng = np.random.default_rng(seed + 1)
    for i, d in enumerate(ds):
        tris = np.concatenate([metrics_main.grid_triangles(g) for g in d["surf_wcs"]])
        j_write_ply(os.path.join(out_dir, f"heldout_{i}.ply"), j_sample_surface(tris, 2000, rng))


@pytest.mark.parametrize("family,kind", [("all", None), ("all", "prism")], ids=["all", "prism"])
def test_heldout_clouds_are_the_jax_bytes(tmp_path, family, kind):
    assert metrics_main.heldout_clouds(str(tmp_path / "t"), 5, 777, family, kind) == 5
    _jax_heldout(str(tmp_path / "j"), 5, 777, family, kind)
    for i in range(5):
        name = f"heldout_{i}.ply"
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()


@pytest.fixture(scope="module")
def resampled(tmp_path_factory):
    """One batch of 4 at 10 x 8 face and edge slots, DDIM 20, recovery on,
    dumped; then a strict replay of the dump."""
    out = tmp_path_factory.mktemp("resample")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # several test processes share the cores
    try:
        common = ["--weights_dir", PACKS, "--sample_batches", "1", "--z_thresholds", "0.2",
                  "--device", "cpu"]
        recovered = resample_main.run(resample_main.parse_args(
            ["--out", str(out / "rec"), "--recover", "--dump", *common]),
            batch_size=BATCH, step_overrides={"fast_steps": STEPS})
        strict = resample_main.main(["--out", str(out / "strict"), "--from_dump",
                                     str(out / "rec" / "batches.npz"), *common])
    finally:
        torch.set_num_threads(threads)
    return out, recovered[0], strict[0]


def _jax_tally(batch, recovery, folder):
    """``resample_demo.py:postprocess``'s counts through JAX's process_one."""
    os.makedirs(folder)
    decoders = _jax_decoders()
    valid = rec = nonsolid = 0
    rungs, failures = {}, {}
    for b in range(batch["surf_mask"].shape[0]):
        name, err = j_process_one(batch, b, *decoders, 0.2, folder, recovery)
        if name is None:
            failures[err.split(":")[0]] = failures.get(err.split(":")[0], 0) + 1
            continue
        valid += 1
        nonsolid += bool(err and "nonsolid" in err)
        if err and err.startswith("recovered"):
            rec += 1
            rungs[err.split(";")[0]] = rungs.get(err.split(";")[0], 0) + 1
    return dict(valid_breps=valid, valid_strict=valid - rec, valid_solid=valid - nonsolid,
                recovered=rungs, failures=failures)


def test_dump_replays_tally_as_jax_process_one(resampled, tmp_path):
    out, recovered, strict = resampled
    batches = resample_main.load_dump(str(out / "rec" / "batches.npz"))
    assert len(batches) == 1 and batches[0]["surf_mask"].shape == (BATCH, 20)
    for line, recovery in ((recovered, True), (strict, False)):
        assert line["attempted"] == BATCH
        want = _jax_tally(batches[0], recovery, str(tmp_path / f"j{recovery}"))
        assert {k: line[k] for k in want} == want, recovery
    assert strict["valid_breps"] == recovered["valid_strict"]
    assert recovered["valid_breps"] >= 1


def test_resample_then_metrics_prints_the_scores(resampled, capsys):
    out, recovered, _ = resampled
    capsys.readouterr()
    avg = metrics_main.main(["--run", str(out), "--samples_dir", str(out / "rec" / "z0.2"),
                             "--heldout", "4", "--times", "1", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == f"clouds: {recovered['valid_breps']} fake vs 4 held-out"
    printed = json.loads(lines[-1])
    assert printed == avg
    assert sorted(printed) == ["avg-COV-CD", "avg-JSD", "avg-MMD-CD", "n_fake_clouds",
                               "n_heldout"]
    assert all(np.isfinite(v) for v in printed.values())


def test_new_entries_leave_jax_out():
    code = ("import sys, brepgen_tpu_torch.cli.resample_main, "
            "brepgen_tpu_torch.cli.metrics_main, brepgen_tpu_torch.sampling.aot\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'brepgen_tpu'))\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, check=True)
