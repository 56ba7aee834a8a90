"""Port: multi-GPU (``brepgen_tpu_torch/parallel/``) on the CPU over gloo.

Two ranks (``tests/torch_port_dist.py``, a file:// rendezvous in the test's
temporary folder) take, each on its rows of the global batch:
- one DistributedDataParallel step of surfpos and of edgez (dropout on; the
  two halves of the edgez batch hold different numbers of valid faces and
  edges), held to the single-process step: loss rtol 1e-5, parameters
  atol 2.5e-4, the bars of JAX's ``test_data_parallel_matches_single_device``,
  and the clipped gradients (AdamW's first moment) atol 1e-6;
- the split tiny cascade (DDIM, class-conditional, compacted PNDM + DDPM)
  against the single-process cascade at 1e-4, with the same bucket on both
  ranks;
- the tensor-parallel forward of a width-64, 4-head, 2-layer denoiser split
  over 2 ranks against the replicated forward (rtol 2e-4, atol 2e-5, JAX's
  ``test_tensor_parallel_forward_matches``), and a contiguous qkv split,
  which differs.
``ldm_main --dp`` under ``torch.distributed.run --nproc_per_node 2`` equals
the single-process CLI run, and its pack loads into the JAX denoiser.
"""

import json
import os
import pickle
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_dist as D
from brepgen_tpu.nn import denoiser as jden
from brepgen_tpu.parallel import distributed as jdist
from brepgen_tpu_torch.cli import ldm_main
from brepgen_tpu_torch.cli.build import seed_weights
from brepgen_tpu_torch.nn import EdgeVAE, SurfVAE
from brepgen_tpu_torch.nn import denoiser as tden
from brepgen_tpu_torch.parallel import distributed, make_mesh
from brepgen_tpu_torch.train.checkpoint import load_params, save_params_npz
from brepgen_tpu_torch.weights import to_flax_params

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
WORKER = os.path.join(ROOT, "tests", "torch_port_dist.py")


@pytest.fixture(autouse=True)
def one_thread():
    # the single-process references run tiny ops: one thread keeps them short
    # on a loaded CPU (many threads on small tensors spin against the other
    # test workers)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _env():
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    return env


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The two ranks' results."""
    folder = tmp_path_factory.mktemp("ranks")
    init = f"file://{folder / 'rendezvous'}"
    out = str(folder / "out")
    procs = [subprocess.Popen([sys.executable, WORKER, "--rank", str(r), "--world", "2",
                               "--init", init, "--out", out], cwd=ROOT, env=_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in (0, 1)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    results = []
    for r in (0, 1):
        with open(f"{out}.{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


@pytest.mark.parametrize("stage", ["surfpos", "edgez"])
def test_ddp_step_matches_single_process(ranks, stage):
    want_metrics, want_params, want_grads = D.train_step(stage)
    for r in ranks:
        metrics, params, grads = r["train"][stage]
        for k, g in want_grads.items():
            np.testing.assert_allclose(grads[k].numpy(), g.numpy(), atol=1e-6, rtol=0,
                                       err_msg=k)
        assert sorted(metrics) == sorted(want_metrics)
        for k, v in want_metrics.items():
            np.testing.assert_allclose(metrics[k], v, rtol=1e-5, err_msg=k)
        for k, v in want_params.items():
            np.testing.assert_allclose(params[k].numpy(), v.numpy(), atol=2.5e-4, rtol=0,
                                       err_msg=k)
    # the ranks' parameters are identical (one all-reduced gradient)
    for k in want_params:
        torch.testing.assert_close(ranks[0]["train"][stage][1][k], ranks[1]["train"][stage][1][k],
                                   rtol=0, atol=0)


def test_edgez_halves_hold_different_counts():
    batch = D.step_batch("edgez")
    valid = (~batch["edge_mask"]).sum(dim=(1, 2))
    assert valid[:4].sum() < valid[4:].sum() / 2
    # the average of the halves' masked means is not the global mean
    rng = np.random.default_rng(0)
    se = torch.from_numpy(rng.random(batch["edge_mask"].shape).astype(np.float32))
    w = (~batch["edge_mask"]).float()
    halves = [(se[s] * w[s]).sum() / w[s].sum() for s in (slice(0, 4), slice(4, 8))]
    assert abs(float(sum(halves) / 2 - (se * w).sum() / w.sum())) > 1e-3


@pytest.mark.parametrize("name", list(D.CASCADES))
def test_split_cascade_matches_single_process(ranks, name):
    want, bucket = D.run_cascade(name)
    parts = [r["cascade"][name] for r in ranks]
    assert [b for _, b in parts] == [bucket, bucket]
    if name == "compact":
        assert bucket < D.CASCADES[name]["num_surfaces"] * 2
    for k, v in want.items():
        got = np.concatenate([p[0][k] for p in parts])
        if v.dtype == bool:
            np.testing.assert_array_equal(got, v, err_msg=k)
        else:
            np.testing.assert_allclose(got, v, atol=1e-4, rtol=0, err_msg=k)


def test_split_sample_loop_returns_the_global_batches(ranks):
    # every rank stops at the same batch (the sample count is summed over
    # the ranks) and holds the global batches: the single-process ones
    want = D.run_sample_loop()
    assert len(want) == 2  # 4 samples a batch, 6 asked for
    for r in ranks:
        got = r["sample_loop"]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k, v in w.items():
                np.testing.assert_allclose(g[k].astype(np.float32), v.astype(np.float32),
                                           atol=1e-4, rtol=0, err_msg=k)


def test_tensor_parallel_forward_matches_replicated(ranks):
    W, H, F = D.TP["width"], D.TP["num_heads"], D.TP["ffn_width"]
    for r in ranks:
        want, got, (qkv, heads, fc1) = r["tp"]
        assert tuple(qkv) == (3 * W // 2, W) and heads == H // 2 and tuple(fc1) == (F // 2, W)
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
        # a contiguous split of the packed [q | k | v] rows gives a rank all
        # of q and part of k: another function
        want_c, got_c, _ = r["tp_contiguous"]
        np.testing.assert_array_equal(want_c, want)
        assert np.abs(got_c - want).max() > 1e-2


@pytest.mark.parametrize("n,world", [(10, 1), (10, 3), (9, 3), (2, 4)])
def test_shard_list_for_rank_is_the_per_host_arithmetic(monkeypatch, n, world):
    items = list(range(n))
    for rank in range(world):
        monkeypatch.setattr(distributed, "rank_and_world", lambda: (rank, world))
        monkeypatch.setattr(jdist.jax, "process_count", lambda: world)
        monkeypatch.setattr(jdist.jax, "process_index", lambda: rank)
        assert distributed.shard_list_for_rank(items) == jdist.shard_list_for_host(items)


def test_row_split_covers_the_batch():
    for n, world in [(8, 2), (7, 3), (2, 4)]:
        rows = [distributed.RowSplit(r, world).rows(n) for r in range(world)]
        got = sum((list(range(n))[s] for s in rows), [])
        assert got == list(range(n))
        assert max(s.stop - s.start for s in rows) - min(s.stop - s.start for s in rows) <= 1


def test_make_mesh_asserts_the_shape():
    with pytest.raises(AssertionError, match=r"\(2, 1\) != 1 ranks"):
        make_mesh((2, 1))
    assert not distributed.maybe_initialize_distributed(device="cpu")


@pytest.fixture(scope="module")
def vae_packs(tmp_path_factory):
    folder = tmp_path_factory.mktemp("vaes")
    gen = torch.Generator().manual_seed(0)
    surf = save_params_npz(str(folder), seed_weights(SurfVAE((8, 8, 8, 8)), gen), "surfvae")
    edge = save_params_npz(str(folder), seed_weights(EdgeVAE((8, 8, 8)), gen), "edgevae")
    return surf, edge


def _cli_argv(folder, vae_packs, *extra):
    return ["--small", "--synthetic", "16", "--option", "edgez", "--train_nepoch", "2",
            "--device", "cpu", "--batch_size", "4", "--max_face", "10", "--max_edge", "8",
            "--num_workers", "0", "--test_nepoch", "1", "--surfvae", vae_packs[0],
            "--edgevae", vae_packs[1], "--dir_name", str(folder), "--env", "edgez", *extra]


def _losses(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_ldm_main_dp_under_torchrun_matches_one_process(tmp_path, vae_packs):
    one = ldm_main.train(ldm_main.get_args(_cli_argv(tmp_path / "one", vae_packs)))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "2", "-m", "brepgen_tpu_torch.cli.ldm_main",
           *_cli_argv(tmp_path / "dp", vae_packs, "--dp")]
    proc = subprocess.run(cmd, cwd=ROOT, env=_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "kernel launches on each of 2 ranks" in proc.stdout
    want, got = _losses(one.metrics_path), _losses(tmp_path / "dp" / "edgez" / "edgez.jsonl")
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    for a, b in zip(got, want):
        for k in a:
            if k not in ("time", "epoch_seconds"):
                np.testing.assert_allclose(a[k], b[k], rtol=1e-5, err_msg=k)
    assert sorted(os.listdir(tmp_path / "dp" / "edgez")) == sorted(
        ["epoch_2.npz", "latest.pt", "edgez.jsonl"])
    pack = str(tmp_path / "dp" / "edgez" / "epoch_2.npz")
    tmodel = load_params(pack, tden.make_edgez_net(**D.SMALL)).eval()
    for k, v in tmodel.state_dict().items():
        np.testing.assert_allclose(v.numpy(), one.state.module.state_dict()[k].numpy(),
                                   atol=2.5e-4, rtol=0, err_msg=k)
    # the rank-0 pack (no "module." prefix) goes into the JAX denoiser
    jmodel = jden.make_edgez_net(**D.SMALL)
    rng = np.random.default_rng(1)
    streams = [rng.normal(size=(2, 80, d)).astype(np.float32)
               for d in tmodel.stream_dims.values()]
    mask = np.zeros((2, 80), bool)
    mask[1, 40:] = True
    t = np.array([3, 700], np.int32)
    want = jmodel.apply(to_flax_params(tmodel), tuple(map(jnp.asarray, streams)),
                        jnp.asarray(t), jnp.asarray(mask))
    with torch.no_grad():
        got = tmodel(tuple(map(torch.from_numpy, streams)), torch.from_numpy(t),
                     torch.from_numpy(mask))
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-4
