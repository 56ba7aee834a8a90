"""Port: the sample CLI's ``--small``, ``--profile`` and ``--aot_cache``, and
``eval_main pc_metric --batch_size``, on the CPU.

``--small`` builds the JAX CLI's tiny debug architecture
(``brepgen_tpu/cli/sample_main.py:63-89``): the same parameter names and
shapes, and with the same seeded weights the same cascade output as the JAX
package for the same injected noise (f32, 1e-4, the port's parity bar).
Stage capture (``sampling/aot.py``) records CUDA graphs and follows the
device: a cascade on the CPU runs eagerly, and ``--aot_cache`` (the graphs'
manifest) raises there. A graph's launch record is held to its kernel
nodes' device functions. Its bookkeeping (one captured call per stage and
signature, a batch's conditioning copied into the static buffers before its
first replay, launch counts added per replay) is checked here with a
stand-in graph that reruns the captured call eagerly on its static buffers;
the card tests (``tests/test_torch_port_cuda.py``) hold real graphs to the
eager path.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brepgen_tpu.cli import sample_main as j_sample_main
from brepgen_tpu.cli.build import build_denoiser as j_build_denoiser
from brepgen_tpu.nn import EdgeVAE as JEdgeVAE
from brepgen_tpu.nn import SurfVAE as JSurfVAE
from brepgen_tpu.sampling import CascadeConfig as JCascadeConfig
from brepgen_tpu.sampling import build_cascade
from brepgen_tpu_torch.cli import eval_main, sample_main
from brepgen_tpu_torch.geometry.ply import write_ply
from brepgen_tpu_torch.kernels import LAUNCH_COUNTS, reset_launch_counts
from brepgen_tpu_torch.sampling import Cascade, CascadeConfig, GeneratorNoise, aot, cascade
from brepgen_tpu_torch.weights import to_flax_params
from test_torch_port_sampling import JaxDraws

STAGES = ("surfpos", "surfz", "edgepos", "edgez")
TINY = dict(batch_size=2, num_surfaces=4, num_edges=3, pndm_steps=10, pos_pndm_calls=8,
            ddpm_tail=5)


@pytest.fixture(autouse=True)
def one_thread():
    """The cascades here are tiny: one intra-op thread each, so that several
    test processes sharing the cores do not thrash."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _shapes(tree):
    """{"a/b/leaf": shape} of a parameter tree (arrays or shape structs)."""
    return {"/".join(str(k.key) for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _jax_small(use_cf):
    """The JAX CLI's --small models with the shapes of their init templates
    (traced, not run)."""
    key = jax.random.PRNGKey(0)
    nets, templates = {}, {}
    for stage in STAGES:
        nets[stage] = j_build_denoiser(stage, use_cf=use_cf, attn_impl="xla", width=32,
                                       num_heads=2, ffn_width=64, num_layers=1)
        templates[stage] = jax.eval_shape(
            lambda n=nets[stage], s=stage: j_sample_main._init_template(n, s, use_cf, key))
    vaes = (JSurfVAE(block_out_channels=(8, 8, 8, 8)), JEdgeVAE(block_out_channels=(8, 8, 8)))
    templates["surf_vae"] = jax.eval_shape(vaes[0].init, key, jnp.zeros((1, 32, 32, 3)))
    templates["edge_vae"] = jax.eval_shape(vaes[1].init, key, jnp.zeros((1, 32, 3)))
    return nets, vaes, templates


@pytest.mark.parametrize("use_cf", [False, True], ids=["uncond", "cf"])
def test_small_has_the_jax_templates(use_cf):
    _, _, templates = _jax_small(use_cf)
    nets, surf_vae, edge_vae = sample_main.load_models(use_cf, small=True, device="cpu")
    port = {**nets, "surf_vae": surf_vae, "edge_vae": edge_vae}
    for name, module in port.items():
        want = _shapes(templates[name])
        assert len(want) > 10 and _shapes(to_flax_params(module)) == want, name


def test_small_cascade_matches_jax_for_the_same_noise():
    nets, surf_vae, edge_vae = sample_main.load_models(False, seed=3, small=True, device="cpu")
    jnets, jvaes, _ = _jax_small(False)
    jcfg = JCascadeConfig(**TINY)
    jcascade = build_cascade(
        jnets, {s: to_flax_params(nets[s]) for s in STAGES},
        lambda p, z: jvaes[0].apply(p, z, method=JSurfVAE.decode), to_flax_params(surf_vae),
        lambda p, z: jvaes[1].apply(p, z, method=JEdgeVAE.decode), to_flax_params(edge_vae),
        jcfg)
    key = jax.random.PRNGKey(5)
    want = {k: np.asarray(v) for k, v in jcascade(key).items()}
    got = Cascade(nets, surf_vae, edge_vae, CascadeConfig(**TINY))(
        JaxDraws(key, jcfg, jcfg.ddpm_tail))
    for k, v in want.items():
        if v.dtype == bool:
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
        else:
            np.testing.assert_allclose(got[k].numpy(), v, atol=1e-4, rtol=0, err_msg=k)


def test_small_refuses_packs_of_another_width():
    packs = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "artifacts",
                         "demo_round5", "all160k", "ckpt_packed")
    with pytest.raises(ValueError, match="demo architecture"):
        sample_main.load_models(False, packs, small=True, device="cpu")


def _cli(tmp_path, *extra):
    return ["--mode", "deepcad", "--small", "--batch_size", "1", "--fast_steps", "2",
            "--device", "cpu", "--strict", "--workers", "1",
            "--save_folder", str(tmp_path / "samples"), *extra]


@pytest.fixture
def tiny_deepcad(monkeypatch):
    monkeypatch.setitem(cascade.MODE_PRESETS, "deepcad",
                        dict(num_surfaces=2, num_edges=2, use_cf=False, class_label=[]))


def test_profile_traces_batch_1_only(tiny_deepcad, tmp_path, monkeypatch, capsys):
    traced = []
    real = sample_main.device_trace

    def recording_trace(log_dir):
        traced.append(log_dir)
        return real(log_dir)

    monkeypatch.setattr(sample_main, "device_trace", recording_trace)
    profile = tmp_path / "profile"
    sample_main.main(_cli(tmp_path, "--max_batches", "3", "--profile", str(profile)))
    assert traced == [None, str(profile), None]
    assert os.listdir(profile) == ["trace.json"]
    out = capsys.readouterr().out
    assert out.count("profile: batch 1:") == 1
    assert "no device kernels in the trace" in out


def test_aot_cache_on_the_cpu_raises_naming_the_card(tiny_deepcad, tmp_path):
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        sample_main.main(_cli(tmp_path, "--max_batches", "1", "--aot_cache",
                              str(tmp_path / "graphs")))
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        aot.StageGraphs(None, "cpu")


def test_capture_follows_the_device():
    assert aot.stage_graphs("cpu") is None
    assert sample_main.init_cascade("deepcad", batch_size=1, device="cpu",
                                    small=True).graphs is None


@pytest.mark.parametrize("names, recorded, ok", [
    (["_ZN12_GLOBAL__N_123packed_attention_kernelIfLi64EEEvPKT_PKhPS1_iif"] * 3
     + ["elementwise_kernel"], {"packed_attention": 3}, True),
    (["_ZN12_GLOBAL__N_129packed_attention_wgmma_kernelI13__nv_bfloat16Li32EEEv14CUtensorMap_st"]
     * 2, {"packed_flash_attention": 2}, True),
    (["packed_attention_kernel"] * 2, {"packed_attention": 3}, False),
    (["packed_attention_kernel", "set_attention_kernel"], {"packed_attention": 1}, False),
    (["dq_kernel", "dkv_kernel"], {"packed_attention_backward": 1}, True),
], ids=["k1", "k2-wgmma", "lost-node", "stray-k3", "k5-two-nodes"])
def test_graph_launches_are_held_to_the_kernel_nodes(names, recorded, ok):
    full = dict.fromkeys(LAUNCH_COUNTS, 0) | recorded
    if ok:
        assert aot.graph_launches(names, full) == recorded
    else:
        with pytest.raises(RuntimeError, match="kernel nodes of"):
            aot.graph_launches(names, full)


def test_pc_metric_batch_size_changes_nothing(tmp_path):
    rng = np.random.default_rng(0)
    for name, n in (("fake", 6), ("real", 4)):
        (tmp_path / name).mkdir()
        for i in range(n):
            write_ply(str(tmp_path / name / f"{i}.ply"), rng.normal(size=(50, 3)))
    texts = []
    for extra in ([], ["--batch_size", "4"]):
        eval_main.main(["pc_metric", "--fake", str(tmp_path / "fake"), "--real",
                        str(tmp_path / "real"), "--n_test", "4", "--multi", "1", "--times",
                        "2", "--seed", "1", "--device", "cpu", *extra])
        texts.append((tmp_path / "fake_results.txt").read_text())
    assert texts[0] == texts[1]
    assert len(texts[0].splitlines()) == 3


class FakeGraph:
    """Stands in for a CUDA graph: a replay reruns the captured call on the
    static buffers and writes the static output in place."""

    def __init__(self, fn, x, t, consts):
        self.fn, self.args = fn, (x, t, *consts)
        self.out = fn(*self.args)

    def replay(self):
        self.out.copy_(self.fn(*self.args))


class EagerGraphs(aot.StageGraphs):
    """StageGraphs on the CPU whose captures are ``FakeGraph``s that count
    ``layers`` packed_attention launches per edge-stage replay."""

    def __init__(self, layers):
        self.cache_dir, self.entries, self.layers = None, [], layers

    def _capture(self, stage, fn, x, consts, dtype):
        self.entries.append(dict(stage=stage, shapes=aot.signature(x, *consts)))
        sx, st = x.clone(), torch.zeros((), dtype=torch.long)
        sc = tuple(None if c is None else c.clone() for c in consts)
        graph = FakeGraph(fn, sx, st, sc)
        launches = {"packed_attention": self.layers} if stage.startswith("edge") else {}
        return aot.CapturedCall(graph, sx, st, sc, graph.out, launches)


@pytest.mark.parametrize("compact", [False, True], ids=["full", "compact"])
def test_captured_calls_replay_each_batch_like_eager(compact):
    """Two batches of different noise (so different conditioning) through
    the static buffers equal the eager cascade batch by batch; one captured
    call per stage and input signature (surfpos: before and after the late
    increase); each replay counts its launches. With compaction the second
    batch's surfpos draws are zeros, so its face slots are all equal and
    dedup keeps one: the edge stages run on another bucket, a new
    signature."""
    models = sample_main.load_models(False, seed=1, small=True, device="cpu")
    cfg = CascadeConfig(**dict(TINY, fast_steps=3, compact=compact, compact_granularity=2))
    graphs = EagerGraphs(layers=1)
    eager, captured = Cascade(*models, cfg), Cascade(*models, cfg, graphs=graphs)
    buckets = []
    for batch in range(2):
        outs = []
        for c in (eager, captured):
            noise = GeneratorNoise(torch.Generator().manual_seed(batch))
            if compact and batch == 1:
                noise = zero_surfpos(noise)
            reset_launch_counts()
            outs.append(c(noise))
        assert LAUNCH_COUNTS["packed_attention"] == 2 * cfg.fast_steps  # edgepos + edgez
        buckets.append(captured.last_bucket)
        for k, v in outs[0].items():
            assert torch.equal(outs[1][k], v), (batch, k)
    stages = [e["stage"] for e in graphs.entries]
    want = ["surfpos", "surfpos", "surfz", "edgepos", "edgez"]
    if compact:
        assert buckets == [cfg.faces, 2]
        want += ["edgepos", "edgez"]
    assert stages == want


def zero_surfpos(noise):
    def draw(site, shape, step=None):
        return torch.zeros(shape) if site.startswith("surfpos") else noise(site, shape, step)
    return draw


def test_no_limit_samples_until_stopped_and_writes_each_batch(tmp_path):
    """F6: with neither ``--num_samples`` nor ``--max_batches`` the CLI
    samples until it is stopped, as the JAX CLI's ``--num_samples 0`` (its
    ``while True``): each batch's raw arrays land in
    ``samples/batches/<batch>.npz`` as they finish; SIGINT ends the run
    after the batch in flight, the postprocess pool drains, the summary is
    printed and the exit status is 0. ``resample_main --from_dump`` reads
    the folder as it reads a ``batches.npz``."""
    import signal
    import subprocess
    import sys
    import time

    from brepgen_tpu_torch.cli.resample_main import load_dump

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, "-m", "brepgen_tpu_torch.cli.sample_main",
                             *_cli(tmp_path)], cwd=root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    folder = tmp_path / "samples" / "batches"
    deadline = time.monotonic() + 240
    try:
        while not (folder / "000001.npz").exists():
            assert proc.poll() is None, f"exited {proc.returncode}: {proc.stdout.read()[-3000:]}"
            assert time.monotonic() < deadline, "no second batch on disk"
            time.sleep(0.05)
        proc.send_signal(signal.SIGINT)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, out[-3000:]
    assert "SIGINT: stopping after the batch in flight" in out
    m = re.search(r"produced (\d+)/(\d+) valid B-reps from (\d+) batches", out)
    assert m, out[-3000:]
    n = int(m.group(3))
    assert n >= 2 and int(m.group(2)) == n  # batch size 1, every sample post-processed
    assert sorted(os.listdir(folder)) == [f"{b:06d}.npz" for b in range(n)]
    assert not (tmp_path / "samples" / "batches.npz").exists()
    batches = load_dump(str(folder))
    assert len(batches) == n
    keys = {"surf_ncs", "surf_pos", "surf_mask", "edge_ncs", "edge_pos", "edge_mask"}
    for b in batches:
        assert keys <= set(b) and b["surf_pos"].shape[0] == 1
        assert all(np.isfinite(v).all() for v in b.values() if v.dtype != bool)
