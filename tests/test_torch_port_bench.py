"""Port: the measuring entry points against the JAX package's, on the CPU.

``brepgen_tpu_torch.bench`` against the root ``bench.py`` (the FLOP count, a
chained step), the cascade's bench hooks (``Cascade.precompile_stage``,
``run_stage_random``) against JAX's with JAX's draws handed in, the Chamfer
protocol bench against JAX's ``pairwise_chamfer``, and every entry's report
keys against its JAX script's (read from the script's source). The entries
run at the tiny architecture on the CPU; the card checks are in
``tests/test_torch_port_bench_cuda.py``.
"""

import ast
import importlib.util
import os
import re
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brepgen_tpu.eval.metrics import pairwise_chamfer as j_pairwise_chamfer
from brepgen_tpu.nn import denoiser as jden
from brepgen_tpu.sampling import CascadeConfig as JCascadeConfig
from brepgen_tpu.sampling import build_cascade
from brepgen_tpu_torch import bench
from brepgen_tpu_torch import nn as tnn
from brepgen_tpu_torch.cli.build import seed_weights
from brepgen_tpu_torch.sampling import Cascade, CascadeConfig, cascade
from brepgen_tpu_torch.sampling.cascade import STAGES
from brepgen_tpu_torch.tools import bench_cascade, chamfer_protocol_bench, io_bench, \
    train_step_bench
from brepgen_tpu_torch.weights import to_flax_params
from test_torch_port_sampling import SMALL, JaxDraws, _models

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
TINY_DEEPCAD = dict(num_surfaces=4, num_edges=3, use_cf=False)
CASCADE_KW = dict(batch_size=2, num_surfaces=4, num_edges=3, pndm_steps=10, pos_pndm_calls=8,
                  ddpm_tail=5)


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


JAX_BENCH = _load("bench.py", "jax_root_bench")


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --- (a) the FLOP count and the constants ------------------------------------
@pytest.mark.parametrize("seq,streams,out", [
    (bench.NS, (6,), 6),
    (bench.NS * bench.NE, (12, 6, 6, 6, 48), 18),
    (32 * 30, (12, 6, 6, 6, 48), 18),
    (48 * 40, (12, 6, 6, 6, 48), 18),
])
@pytest.mark.parametrize("arch", [{}, dict(width=32, ffn=64, layers=1)])
def test_flops_per_eval_equal_bench_py(seq, streams, out, arch):
    want = JAX_BENCH.denoiser_flops_per_eval(bench.B, seq, streams, out, **arch)
    assert bench.denoiser_flops_per_eval(bench.B, seq, streams, out, **arch) == want
    for name in ("B", "NS", "NE", "SURF_EVALS", "EDGE_EVALS", "REFERENCE_BREPS_PER_MIN"):
        assert getattr(bench, name) == getattr(JAX_BENCH, name), name


# --- (b) one chained bench step ------------------------------------------------
@pytest.mark.parametrize("stage", ["surfpos", "edgez"])
def test_chained_step_matches_jax(stage):
    B, S = 2, 24
    rng = np.random.default_rng(5)
    attn = "kernel" if stage == "edgez" else "plain"
    net = seed_weights(getattr(tnn, f"make_{stage}_net")(attn_impl=attn, **SMALL),
                       torch.Generator().manual_seed(1)).eval()
    jnet = getattr(jden, f"make_{stage}_net")(**SMALL)
    params = to_flax_params(net)
    t = jnp.full((B,), bench.T_EVAL, jnp.int32)
    if stage == "surfpos":
        x = rng.normal(size=(B, S, 6)).astype(np.float32)
        step, consts = bench.surf_step(net), (None, None, None)
        jstep = jax.jit(lambda x: jnet.apply(params, (x,), t))
    else:
        x = rng.normal(size=(B, S, 18)).astype(np.float32)
        cond = rng.normal(size=(B, S, 60)).astype(np.float32)
        mask = np.zeros((B, S), bool)
        step = bench.edge_step(net)
        consts = (torch.from_numpy(cond), torch.from_numpy(mask), None)
        streams = (cond[..., :6], cond[..., 6:12], cond[..., 12:])
        jstep = jax.jit(lambda x: jnet.apply(
            params, (x[..., :12], x[..., 12:]) + streams, t, jnp.asarray(mask)))
    got, want = torch.from_numpy(x), jnp.asarray(x)
    with torch.inference_mode():
        for _ in range(2):  # each output, normalised, is the next input
            got = step(got, torch.tensor(bench.T_EVAL), *consts)
            out = jstep(want)
            want = (out / (jnp.abs(out).max() + 1e-6)).astype(want.dtype)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


# --- (c) the cascade's bench hooks ---------------------------------------------
def _stage_draws(key, jcfg):
    """JAX's draws inside one stage run on ``key`` (``cascade.py:614-633``):
    surfpos splits it for its initial noise and DDPM tail, the edgepos tail
    folds in 1, the other stages draw their initial noise from it."""
    draws = JaxDraws(key, jcfg, jcfg.ddpm_tail)
    k0, k1 = jax.random.split(key)
    draws.inits = {"surfpos": k0, "surfz": key, "edgepos": key, "edgez": key}
    draws.tails = {"surfpos_ddpm": (k1, jcfg.ddpm_tail),
                   "edgepos_ddpm": (jax.random.fold_in(key, 1), jcfg.ddpm_tail)}
    return draws


@pytest.fixture(scope="module")
def cascades():
    models = _models(False)
    jcfg = JCascadeConfig(**CASCADE_KW)
    tcascade = Cascade(*models[1], CascadeConfig(**CASCADE_KW))
    return build_cascade(*models[0], jcfg), tcascade, jcfg


@pytest.mark.parametrize("ns_c", [None, 2])
@pytest.mark.parametrize("name", STAGES)
def test_run_stage_random_matches_jax(cascades, name, ns_c):
    jcascade, tcascade, jcfg = cascades
    seed = 11
    ks = jax.random.split(jax.random.PRNGKey(seed), 6)
    inputs = [np.array(jax.random.normal(k, s))
              for k, s in zip(ks[1:], tcascade.stage_inputs(name, ns_c))]
    want = jax.tree.leaves(jcascade.run_stage_random(name, seed, ns_c=ns_c))
    got = tcascade.run_stage_random(name, seed, ns_c=ns_c, inputs=inputs,
                                    noise=_stage_draws(ks[0], jcfg))
    got = [got] if isinstance(got, torch.Tensor) else list(got)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape
        if w.dtype == bool:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)
    if name in ("edgepos", "edgez") and ns_c:
        assert got[-1].shape[1] == ns_c


def test_run_stage_random_draws_its_own_inputs(cascades):
    _, tcascade, _ = cascades
    a = tcascade.run_stage_random("edgez", 3, ns_c=2)
    b = tcascade.run_stage_random("edgez", 3, ns_c=2)
    assert torch.equal(a[1], b[1]) and a[1].shape == (2, 2, 3, 18)
    assert not torch.equal(a[1], tcascade.run_stage_random("edgez", 4, ns_c=2)[1])
    with pytest.raises(ValueError, match="expected"):
        tcascade.run_stage_random("surfz", 3, inputs=[np.zeros((2, 3, 6))])


def test_precompile_stage_runs_every_stage(cascades):
    _, tcascade, _ = cascades
    for name in STAGES:
        before = dict(tcascade.model_calls)
        tcascade.precompile_stage(name)
        moved = {s for s in before if tcascade.model_calls[s] != before[s]}
        assert moved == (set() if name == "decode" else {name})
    with pytest.raises(ValueError, match="unknown stage"):
        tcascade.precompile_stage("edges")


# --- (d) the Chamfer protocol bench --------------------------------------------
def test_chamfer_protocol_matches_jax():
    rng = np.random.default_rng(2)
    fake, real, fake2 = (chamfer_protocol_bench.clouds(rng, n, 64) for n in (7, 5, 7))
    fields, d, d2 = chamfer_protocol_bench.protocol(fake, real, fake2, "cpu", rows=3)
    want = np.asarray(j_pairwise_chamfer(fake, real))
    np.testing.assert_allclose(d, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(d2, np.asarray(j_pairwise_chamfer(fake2, real)), atol=1e-6,
                               rtol=0)
    assert fields["mmd_sanity"] == pytest.approx(float(want.min(axis=0).mean()), abs=1e-6)
    assert fields["cov_sanity"] == len(np.unique(np.argmin(want, axis=1))) / want.shape[1]


# --- (e) every entry's report keys against its JAX script's --------------------
def _key_pattern(node):
    """A regular expression of a key: an f-string's fields match anything,
    and so does the batch size in a literal key (``bs128``: the port's keys
    carry the batch size of the run)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return re.sub(r"_bs\d+_", "_bs.+_", re.escape(node.value))
    if isinstance(node, ast.JoinedStr):
        return "".join(re.escape(v.value) if isinstance(v, ast.Constant) else ".+"
                       for v in node.values)
    return None


def _jax_report_keys(path):
    """Patterns of the keys a JAX script reports: the dicts it assigns to
    ``result`` / ``report`` or dumps as JSON (nested dicts included) and the
    keys it stores into ``report``."""
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read())
    keys = set()

    def add(d):
        for k, v in zip(d.keys, d.values):
            keys.add(_key_pattern(k))
            if isinstance(v, ast.Dict):
                add(v)

    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            target = node.targets[0]
            if isinstance(target, ast.Name) and target.id in ("result", "report") \
                    and isinstance(node.value, ast.Dict):
                add(node.value)
            if isinstance(target, ast.Subscript) and getattr(target.value, "id", "") == "report":
                keys.add(_key_pattern(target.slice))
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "dumps" \
                and node.args and isinstance(node.args[0], ast.Dict):
            add(node.args[0])
    keys.discard(None)
    return keys


def _hold_keys(got, jax_script, dropped=(), added=()):
    patterns = _jax_report_keys(jax_script) - {re.escape(k) for k in dropped}
    assert set(added) <= got.keys(), got.keys()
    got = set(got) - set(added)
    assert not set(dropped) & got
    unmatched = {k for k in got if not any(re.fullmatch(p, k) for p in patterns)}
    assert not unmatched, unmatched
    missing = {p for p in patterns if not any(re.fullmatch(p, k) for k in got)}
    assert not missing, missing


@pytest.fixture
def tiny_deepcad(monkeypatch):
    monkeypatch.setitem(cascade.MODE_PRESETS, "deepcad", TINY_DEEPCAD)
    monkeypatch.setattr(bench, "B", 2)
    monkeypatch.setenv("BREPGEN_BENCH_BATCH", "2")


def test_bench_keys_equal_bench_py(tiny_deepcad, one_thread):
    result = bench.main(["--device", "cpu", "--small", "--steps", "1"])
    assert result["detail"]["mfu_peak_tflops"] == 989.0
    assert result["detail"]["device"] == "cpu" and result["detail"]["edge_mfu_vs_peak"] is None
    assert np.isfinite(result["detail"]["measured_cascade_s_per_batch16"])
    flat = {**result, **result["detail"]}
    _hold_keys(flat, "bench.py", dropped=["backend"],
               added=["device", "power_limit_w", "timing", "measured_cascade_s_per_batch16",
                      "k1_launches_per_edge_step"])


def test_bench_cascade_keys_equal_script(tiny_deepcad, one_thread, capsys):
    full = bench_cascade.main(["deepcad", "kernel", "", "--device", "cpu", "--small"])
    assert set(full["stage_s"]) == set(STAGES) and full["batch_size"] == 2
    timed = bench_cascade.main(["deepcad", "plain", "", "time:edgez@2", "1", "--device", "cpu",
                                "--small"])
    assert timed["ns_c"] == 2 and len(timed["times_s"]) == 1
    assert bench_cascade.main(["deepcad", "kernel", "", "edgepos", "--device", "cpu",
                               "--small"])["precompiled"] == "edgepos"
    assert "precompiled edgepos in" in capsys.readouterr().out
    _hold_keys({**full, **timed}, "scripts/bench_cascade.py",
               dropped=["projected_3k_run_v5e8_hours"])


def test_train_step_bench_keys_equal_script(monkeypatch, one_thread):
    for name, value in (("B", 2), ("NF", 4), ("NE", 3)):
        monkeypatch.setattr(train_step_bench, name, value)
    report = train_step_bench.main(["--device", "cpu", "--small", "--steps", "1"])
    assert set(report) == {f"edgez_bs2_{a}_{u}" for a in ("plain", "kernel")
                           for u in ("ms", "steps_per_s")}
    _hold_keys(report, "scripts/train_attn_bench.py")


def test_chamfer_protocol_bench_keys_equal_script(monkeypatch, tmp_path):
    for name, value in (("N_FAKE", 6), ("N_REAL", 5), ("P", 40)):
        monkeypatch.setattr(chamfer_protocol_bench, name, value)
    out = tmp_path / "sub" / "chamfer.json"
    report = chamfer_protocol_bench.main([str(out), "--device", "cpu"])
    assert report["backend"] == "cpu" and out.exists()
    assert report["shape"] == "6x5 pairs, 40 pts"
    _hold_keys(report, "scripts/chamfer_protocol_bench.py")


def test_io_bench_keys_equal_script(monkeypatch, one_thread):
    for name, value in (("BATCHES", 1), ("WORKERS", (0,)), ("SURFPOS_BS", 4), ("EDGEZ_BS", 2)):
        monkeypatch.setattr(io_bench, name, value)
    small = ["--device", "cpu", "--small", "--steps", "1"]
    report = io_bench.main(small)
    cached = io_bench.main(["cached_only"] + small)
    assert set(cached) == {"host_cpus", "device", "device_edgez_bs2_cached_latents_steps_per_s"}
    assert report["device"] == "cpu"
    _hold_keys({**report, **cached}, "scripts/io_bench.py", added=["device"])


def test_card_reads_name_and_power_limit(monkeypatch):
    import brepgen_tpu_torch as port

    calls = []

    def smi(cmd, **kw):
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, "NVIDIA H100 80GB HBM3, 700.00 W\n")

    monkeypatch.setattr(port.subprocess, "run", smi)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: f"card {i}")
    assert port.nvidia_smi_card(1) == "NVIDIA H100 80GB HBM3, 700.00 W"
    info = port.card(torch.device("cuda", 1))
    assert info == {"device": "card 1", "power_limit_w": 700.0}
    assert calls[-1][:2] == ["nvidia-smi", "--id=1"]
    assert port.card_line(info) == "device: card 1, power limit 700.00 W"
    assert port.card_line(port.card(torch.device("cpu"))) == "device: cpu"


# --- (f) no card and no --device cpu: every entry raises -----------------------
@pytest.mark.parametrize("entry,argv", [
    (bench.main, []),
    (bench_cascade.main, []),
    (bench_cascade.main, ["deepcad", "kernel", "", "time:edgez@24", "1"]),
    (train_step_bench.main, []),
    (chamfer_protocol_bench.main, []),
    (io_bench.main, ["cached_only"]),
])
def test_entry_raises_without_card(monkeypatch, entry, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry(argv)
