"""Port: selective checkpointing (``remat="dots"``) and the profiling hooks,
on the CPU.

The port of ``tests/test_train.py::test_remat_preserves_params_and_step``:
an edgez step with remat False, True and "dots" gives the same loss,
gradients and parameters (1e-6, f32, dropout on: the recompute draws the
same masks), and the "dots" step matches JAX's "dots" step with JAX's draws
replayed (dropout 0; loss 1e-5, clipped gradients 1e-4, parameters 1e-4
where JAX's gradient exceeds 1e-6, else 2 * lr, the bars of
``tests/test_torch_port_train.py``). With the kernel launchers standing in
on the CPU, "dots" launches K1 twice per layer (forward and recompute) and K5
once, as remat True does, while the recompute skips the dense products.
``--profile DIR`` writes a trace and leaves the trained parameters
bit-equal; the trace reader's busy time and idle share are checked on a
trace of known intervals; ``StageTimer`` reports the stages and counts of
JAX's.
"""

import json
import time
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from brepgen_tpu.diffusion import make_ddpm_tables as j_tables
from brepgen_tpu.nn import denoiser as jden
from brepgen_tpu.train import common as jcommon
from brepgen_tpu.train import ldm_train as jlt
from brepgen_tpu.utils.profiling import StageTimer as JStageTimer
from brepgen_tpu_torch.cli import ldm_main
from brepgen_tpu_torch.cli.build import seed_weights
from brepgen_tpu_torch.diffusion.ddpm import make_ddpm_tables
from brepgen_tpu_torch.nn import denoiser as tden
from brepgen_tpu_torch.nn.transformer import TransformerEncoder
from brepgen_tpu_torch.train import ldm_train
from brepgen_tpu_torch.train.checkpoint import save_params_npz
from brepgen_tpu_torch.train.common import TrainState, make_ldm_optimizer
from brepgen_tpu_torch.utils import profiling
from brepgen_tpu_torch.weights import flatten_params, load_flax_params, to_flax_params
from test_torch_port_latent_cache import GradCapture
from test_torch_port_train import (
    MAX_EDGE,
    MAX_FACE,
    SMALL,
    _batch,
    _flat_jax,
    _jax_draws,
    _torch_grads_flax,
    _vaes,
)
from test_torch_port_train_attention import _stand_in_launchers

REMATS = (False, True, "dots")


@pytest.fixture(autouse=True)
def one_thread():
    # one thread keeps the runs short on a loaded CPU
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def vaes():
    return _vaes()


def _edgez_step(net, vaes, batch, draws=None, generator=None):
    _, (surf_encode, edge_encode) = vaes
    capture = GradCapture(net)
    step = ldm_train.make_edgez_step(net, make_ddpm_tables(), surf_encode, edge_encode)
    m = step(TrainState(net, capture), batch, generator, draws)
    return float(m["loss"]), capture.grads


def test_remat_modes_give_equal_steps(vaes):
    # dropout 0.1 on: each layer's recompute must draw its first pass's masks
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in _batch("edgez", seed=4).items()}
    kw = dict(SMALL, dropout=0.1, num_layers=2)
    base = seed_weights(tden.make_edgez_net(attn_impl="kernel", **kw),
                        torch.Generator().manual_seed(1))
    out = {}
    for remat in REMATS:
        net = tden.make_edgez_net(attn_impl="kernel", remat=remat, **kw)
        net.load_state_dict(base.state_dict())
        assert net.encoder.remat == remat
        out[remat] = _edgez_step(net, vaes, batch, generator=torch.Generator().manual_seed(2))
    loss0, g0 = out[False]
    for remat in (True, "dots"):
        loss, g = out[remat]
        assert abs(loss - loss0) <= 1e-6 * abs(loss0), remat
        assert sorted(g) == sorted(g0)
        for k in g0:
            assert (g[k] - g0[k]).abs().max() <= 1e-6, (remat, k)


def test_dots_step_matches_jax(vaes):
    jvae, (surf_encode, edge_encode) = vaes
    batch = _batch("edgez", seed=4)
    jmodel = jden.make_edgez_net(remat="dots", **SMALL)
    B, S = 2, MAX_FACE * MAX_EDGE
    streams = tuple(jnp.zeros((B, S, d)) for d in (12, 6, 6, 6, 48))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(1), streams, jnp.zeros((B,), jnp.int32))
    rng = jax.random.PRNGKey(7)
    draws = _jax_draws("edgez", jmodel, params, rng, batch, jvae, False)
    opt = jcommon.make_ldm_optimizer()
    se, sp, ee, ep = jvae
    jstate, jm = jlt.make_edgez_step(jmodel, opt, j_tables(), se, sp, ee, ep, False)(
        jcommon.init_state(params, opt), {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    tmodel = load_flax_params(tden.make_edgez_net(attn_impl="kernel", remat="dots", **SMALL),
                              params)
    state = TrainState(tmodel, make_ldm_optimizer(tmodel.parameters()))
    step = ldm_train.make_edgez_step(tmodel, make_ddpm_tables(), surf_encode, edge_encode)
    tm = step(state, {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}, None, draws)
    for k in ("loss", "loss_z", "loss_v"):
        assert abs(float(tm[k]) - float(jm[k])) <= 1e-5, k
    b1, lr = 0.95, 5e-4
    jgrads = {k: v / (1 - b1) for k, v in _flat_jax(jstate.opt_state[1][0].mu).items()}
    tgrads = _torch_grads_flax(tmodel, {n: state.optimizer.adamw.state[p]["exp_avg"] / (1 - b1)
                                        for n, p in tmodel.named_parameters()})
    assert sorted(tgrads) == sorted(jgrads)
    for k, g in jgrads.items():
        assert np.abs(tgrads[k] - g).max() <= 1e-4, k
    got = flatten_params(to_flax_params(tmodel))
    for k, v in _flat_jax(jstate.params).items():
        diff = np.abs(got[k] - v)
        live = np.abs(jgrads[k]) > 1e-6
        assert diff[live].max(initial=0.0) <= 1e-4, k
        assert diff.max() <= 2 * lr, k


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] += 1
        return func(*args, **(kwargs or {}))


def test_dots_reruns_the_kernel_and_keeps_the_dense_products(monkeypatch):
    # the kernel path taken on the CPU: each launcher returns its plain
    # result detached, as a ctypes-filled output is
    calls = _stand_in_launchers(monkeypatch)
    layers = 2
    x = torch.randn((2, 24, 32), generator=torch.Generator().manual_seed(0))
    mask = torch.zeros((2, 24), dtype=torch.bool)
    mask[1, 10:] = True
    grads, addmm = {}, {}
    for remat in REMATS:
        torch.manual_seed(0)
        enc = TransformerEncoder(32, 2, 64, layers, attn_impl="kernel", remat=remat)
        for k in calls:
            calls[k] = 0
        out = enc(x, mask, train=True, generator=torch.Generator().manual_seed(3))
        counter = _OpCount()
        with counter:
            out.square().sum().backward()
        forward = 1 if remat is False else 2  # the recompute runs K1 again
        assert calls == {"packed": forward * layers, "backward": layers, "set": 0}, remat
        addmm[remat] = counter.counts[torch.ops.aten.addmm.default]
        grads[remat] = [p.grad for p in enc.parameters()]
    # the backward of remat True recomputes qkv, proj, fc1 and fc2 of each
    # layer; "dots" takes them from what the forward kept
    assert addmm[False] == addmm["dots"] == 0 and addmm[True] == 4 * layers
    for remat in (True, "dots"):
        for a, b in zip(grads[remat], grads[False]):
            assert (a - b).abs().max() <= 1e-6


def test_unknown_remat_raises():
    with pytest.raises(ValueError, match="remat must be one of"):
        TransformerEncoder(32, 2, 64, 1, remat="selective")


@pytest.fixture(scope="module")
def vae_packs(tmp_path_factory):
    from brepgen_tpu_torch.nn import EdgeVAE, SurfVAE

    folder = tmp_path_factory.mktemp("vaes")
    gen = torch.Generator().manual_seed(0)
    return (save_params_npz(str(folder), seed_weights(SurfVAE((8, 8, 8, 8)), gen), "surfvae"),
            save_params_npz(str(folder), seed_weights(EdgeVAE((8, 8, 8)), gen), "edgevae"))


def test_profile_writes_a_trace_and_leaves_training_unchanged(tmp_path, vae_packs, capsys):
    # 8 solids in batches of 4: two steps an epoch, so the window opens at
    # step 10 (epoch 6) and closes at that epoch's end
    def run(*extra):
        return ldm_main.train(ldm_main.get_args([
            "--small", "--synthetic", "8", "--option", "edgez", "--train_nepoch", "6",
            "--device", "cpu", "--batch_size", "4", "--max_face", str(MAX_FACE), "--max_edge",
            str(MAX_EDGE), "--num_workers", "0", "--test_nepoch", "6", "--surfvae", vae_packs[0],
            "--edgevae", vae_packs[1], "--dir_name", str(tmp_path), "--env", "e", *extra]))

    plain = run()
    traced = run("--profile", str(tmp_path / "trace"))
    assert plain.trace is None and traced.state.step == plain.state.step == 12
    assert (traced.trace.first_step, traced.trace.last_step) == (10, 11)
    assert traced.trace.path == str(tmp_path / "trace" / profiling.TRACE_FILE)
    summary = profiling.summarize_trace(traced.trace.path)
    assert summary["window_ms"] > 0 and summary["kernels"] == 0
    assert summary["device_idle_share"] is None  # no card: no device time
    assert "profile: steps 10-11: window" in capsys.readouterr().out
    for p, q in zip(plain.state.module.parameters(), traced.state.module.parameters()):
        assert torch.equal(p, q)


def test_trace_summary_counts_the_union_of_kernel_intervals(tmp_path):
    # a window of 100 us with kernels over [10, 30) and [20, 50) (overlapping)
    # and [80, 90): busy 50 us, idle share 0.5
    events = [{"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0.0, "dur": 100.0},
              {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 10.0, "dur": 20.0},
              {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 20.0, "dur": 30.0},
              {"ph": "X", "cat": "kernel", "name": "softmax", "ts": 80.0, "dur": 10.0},
              {"ph": "i", "name": "marker", "ts": 500.0}]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    s = profiling.summarize_trace(str(path))
    assert s["window_ms"] == pytest.approx(0.1) and s["device_busy_ms"] == pytest.approx(0.05)
    assert s["device_idle_share"] == pytest.approx(0.5) and s["kernels"] == 3
    assert s["top"] == [("gemm", pytest.approx(0.05), 2), ("softmax", pytest.approx(0.01), 1)]
    assert "device idle share 0.5000" in profiling.format_summary(s)


def test_stage_timer_reports_as_jax():
    timers = (profiling.StageTimer(), JStageTimer())
    for timer in timers:
        for name in ("encode", "denoise", "encode", "decode", "encode"):
            # 10 ms a stage: "encode" (three) leads the report by 20 ms, more
            # than a loaded machine's scheduling jitter on one sleep
            with timer.stage(name, block_on=torch.zeros(2) if timer is timers[0] else None):
                time.sleep(0.01)
    (mine, theirs) = (t.summary() for t in timers)
    assert sorted(mine) == sorted(theirs) == ["decode", "denoise", "encode"]
    for k in mine:
        assert mine[k]["count"] == theirs[k]["count"]
        assert mine[k]["total_s"] >= 0.01 * mine[k]["count"]
    assert [line.split(":")[0] for line in timers[0].report().splitlines()][0].strip() == "encode"
    with profiling.device_trace(None):
        pass
