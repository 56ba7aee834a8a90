"""Port: the span recorder of ``utils/profiling.py`` and the spans the program
opens, on the CPU (one case on the card).

Off by default: a span is one shared no-op context, records nothing, calls
no ``record_function`` and makes no CUDA event. Under a CPU profiler a span
records its parent, self time and ids, and its times lie within 1 ms of its
``record_function`` event in the profiler's own results (kineto's clock is
the epoch's). Traced, the tiny cascade opens one ``brepgen.cascade.update``
a scheduler step and one ``brepgen.cascade.denoise`` a model call, with the
batch's index, and returns bit-equal outputs; a tiny edgez step nests
encode, forward, backward and optimizer under its step span and leaves the
parameters bit-equal; the scorers return what they return untraced. The
trace reader counts copies and fills as busy, not the device-side copies of
host annotations, and labels an idle gap by the span covering most of it.
Marked ``cuda``: a ``device=True`` span around one K4 launch reads the
kernel's profiler time within 5%. This file imports no JAX.
"""

import copy
import json
import time

import numpy as np
import pytest
import torch

from brepgen_tpu_torch.cli import sample_main
from brepgen_tpu_torch.cli.build import seed_weights
from brepgen_tpu_torch.diffusion.ddpm import make_ddpm_tables
from brepgen_tpu_torch.eval import metrics
from brepgen_tpu_torch.nn import EdgeVAE, SurfVAE
from brepgen_tpu_torch.nn import denoiser as tden
from brepgen_tpu_torch.sampling import Cascade, CascadeConfig, GeneratorNoise
from brepgen_tpu_torch.train import ldm_train
from brepgen_tpu_torch.train.common import TrainState, make_ldm_optimizer
from brepgen_tpu_torch.train.vae_train import make_encoder_fn
from brepgen_tpu_torch.utils import profiling

TINY = dict(batch_size=2, num_surfaces=4, num_edges=3, pndm_steps=10, pos_pndm_calls=8,
            ddpm_tail=5)
SMALL = dict(width=32, num_heads=2, ffn_width=64, num_layers=1, dropout=0.0)
STEP_PARTS = ("encode", "forward", "backward", "optimizer")


@pytest.fixture(autouse=True)
def fresh_recorder():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    profiling.reset()
    yield
    profiling.reset()
    torch.set_num_threads(threads)


def cpu_profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def by_name(name):
    return [s for s in profiling.spans() if s.name == name]


class Counting:
    """Stands in for ``record_function`` or ``torch.cuda.Event``, counting
    the objects made."""

    made = 0

    def __init__(self, *a, **k):
        type(self).made += 1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def record(self):
        pass

    def elapsed_time(self, end):
        return 2.5  # ms


@pytest.fixture
def fake_card(monkeypatch):
    """A card the recorder believes in: CUDA events are ``Counting``."""
    class Event(Counting):
        made = 0

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    return Event


@pytest.fixture(scope="module")
def tiny_models():
    return sample_main.load_models(False, seed=3, small=True, device="cpu")


def _eval_inputs():
    rng = np.random.default_rng(4)
    return (rng.normal(size=(6, 64, 3)).astype(np.float32),
            rng.normal(size=(5, 64, 3)).astype(np.float32))


def _score(s, r):
    d = metrics.pairwise_chamfer(s, r, "cpu")
    return d, metrics.cov_mmd_from_matrix(d), metrics.jsd_between_point_cloud_sets(s, r)


def _edgez_step():
    gen = torch.Generator().manual_seed(3)
    encoders = (make_encoder_fn(seed_weights(SurfVAE((8, 8, 8, 8)), gen).eval()),
                make_encoder_fn(seed_weights(EdgeVAE((8, 8, 8)), gen).eval()))
    net = seed_weights(tden.make_edgez_net(**SMALL), torch.Generator().manual_seed(1))
    state = TrainState(net, make_ldm_optimizer(net.parameters()))
    r = torch.Generator().manual_seed(5)
    B, nf, ne = 2, 3, 2
    batch = {"edgepnt": torch.randn(B, nf, ne, 32, 3, generator=r),
             "edgepos": torch.randn(B, nf, ne, 6, generator=r),
             "edge_mask": torch.zeros(B, nf, ne, dtype=torch.bool),
             "surfpnt": torch.randn(B, nf, 32, 32, 3, generator=r),
             "surfpos": torch.randn(B, nf, 6, generator=r),
             "vertpos": torch.randn(B, nf, ne, 6, generator=r)}
    return state, batch, encoders


# --- the recorder ---------------------------------------------------------------------
def test_off_by_default_records_nothing(monkeypatch, fake_card, tiny_models):
    class RecordFunction(Counting):
        made = 0

    monkeypatch.setattr(torch.profiler, "record_function", RecordFunction)
    assert profiling.span("brepgen.a", device=True, x=1) is profiling.span("brepgen.b")
    Cascade(*tiny_models, CascadeConfig(**dict(TINY, fast_steps=2)))(
        GeneratorNoise(torch.Generator().manual_seed(0)))
    state, batch, encoders = _edgez_step()
    ldm_train.make_edgez_step(state.module, make_ddpm_tables(), *encoders)(
        state, batch, torch.Generator().manual_seed(2))
    _score(*_eval_inputs())
    with profiling.StageTimer().stage("brepgen.stage"):
        pass
    assert profiling.spans() == [] and profiling.summary() == {}
    assert RecordFunction.made == 0 and fake_card.made == 0
    with profiling.recording():
        assert profiling.span("brepgen.a") is not profiling.span("brepgen.a")
        with profiling.span("brepgen.a", device=True):
            pass
    assert RecordFunction.made == 1 and fake_card.made == 2
    assert profiling.summary()["brepgen.a"]["device_s"] == pytest.approx(2.5e-3)


def test_parents_self_times_and_ids_on_the_profilers_clock():
    with cpu_profile() as prof:
        with profiling.span("brepgen.test.outer", batch=7):
            time.sleep(0.004)
            with profiling.span("brepgen.test.inner", stage="edgez", call=3):
                time.sleep(0.006)
            with profiling.span("brepgen.test.inner", stage="edgez", call=4):
                time.sleep(0.002)
    outer, inner, inner2 = profiling.spans()
    assert (outer.parent, inner.parent, inner2.parent) == (-1, 0, 0)
    assert outer.ids == {"batch": 7} and inner.ids == {"stage": "edgez", "call": 3}
    s = profiling.summary()
    assert s["brepgen.test.inner"]["count"] == 2 and s["brepgen.test.outer"]["count"] == 1
    children = s["brepgen.test.inner"]["host_s"]
    assert children >= 0.008
    assert s["brepgen.test.outer"]["self_s"] == pytest.approx(
        s["brepgen.test.outer"]["host_s"] - children, abs=1e-9)
    assert 0.004 <= s["brepgen.test.outer"]["self_s"] < s["brepgen.test.outer"]["host_s"]
    assert s["brepgen.test.inner"]["self_s"] == s["brepgen.test.inner"]["host_s"]
    events = sorted((e for e in prof.profiler.kineto_results.events()
                     if e.name().startswith("brepgen.test.")), key=lambda e: e.start_ns())
    assert [e.name() for e in events] == [sp.name for sp in (outer, inner, inner2)]
    for e, sp in zip(events, (outer, inner, inner2)):
        assert abs(e.start_ns() - sp.start_ns) < 1_000_000, sp.name
        assert abs(e.end_ns() - sp.end_ns) < 1_000_000, sp.name


def test_starting_a_trace_starts_a_new_recording(tmp_path):
    with profiling.recording():
        with profiling.span("brepgen.before"):
            pass
    timer = profiling.StageTimer()
    with profiling.device_trace(str(tmp_path)):
        with timer.stage("brepgen.stage"):
            pass
    assert [s.name for s in profiling.spans()] == ["brepgen.stage"]
    assert timer.counts["brepgen.stage"] == 1


# --- the program's spans ----------------------------------------------------------------
@pytest.mark.parametrize("fast_steps", [0, 3])
def test_cascade_spans_count_updates_and_calls_and_change_nothing(tiny_models, fast_steps):
    cfg = CascadeConfig(**dict(TINY, fast_steps=fast_steps))

    def batches(c):
        gen = torch.Generator().manual_seed(11)
        return [c(GeneratorNoise(gen)) for _ in range(2)]

    plain = batches(Cascade(*tiny_models, cfg))
    c = Cascade(*tiny_models, cfg)
    with cpu_profile():
        traced = batches(c)
    for want, got in zip(plain, traced):
        for k in want:
            assert torch.equal(want[k], got[k]), k
    if fast_steps:
        steps = 2 * (len(c.ddim_plan_hi.t) + len(c.ddpm_tail_plan.t) + 3 * len(c.ddim_plan.t))
    else:
        steps = 2 * (2 * (len(c.pndm_pos_plan.t_model) + len(c.ddpm_plan.t))
                     + 2 * len(c.pndm_full_plan.t_model))
    s = profiling.summary()
    assert s["brepgen.cascade.update"]["count"] == steps
    assert s["brepgen.cascade.denoise"]["count"] == sum(c.model_calls.values()) == steps
    assert s["brepgen.cascade.dedup"]["count"] == 2
    spans = profiling.spans()
    for stage in ("surfpos", "surfz", "edgepos", "edgez", "decode"):
        assert [sp.ids["batch"] for sp in by_name(f"brepgen.cascade.{stage}")] == [0, 1]
    denoise = by_name("brepgen.cascade.denoise")
    assert {sp.ids["batch"] for sp in denoise} == {0, 1}
    for sp in denoise + by_name("brepgen.cascade.update"):
        assert spans[sp.parent].name.startswith("brepgen.cascade.")
    for stage in ("surfpos", "edgez"):
        calls = [sp.ids["call"] for sp in denoise if sp.ids["stage"] == stage]
        assert calls == list(range(1, len(calls) + 1))
        assert all(spans[sp.parent].name == f"brepgen.cascade.{stage}"
                   for sp in denoise if sp.ids["stage"] == stage)


def test_train_step_spans_nest_and_change_nothing():
    state, batch, encoders = _edgez_step()
    twin = copy.deepcopy(state)
    tables = make_ddpm_tables()
    ldm_train.make_edgez_step(state.module, tables, *encoders)(
        state, batch, torch.Generator().manual_seed(2))
    with profiling.recording():
        ldm_train.make_edgez_step(twin.module, tables, *encoders)(
            twin, batch, torch.Generator().manual_seed(2))
    for p, q in zip(state.module.parameters(), twin.module.parameters()):
        assert torch.equal(p, q)
    spans = profiling.spans()
    assert [sp.name for sp in spans] == ["brepgen.train.step"] + [
        f"brepgen.train.{k}" for k in STEP_PARTS]
    assert spans[0].ids == {"step": 0} and spans[0].parent == -1
    assert all(sp.parent == 0 for sp in spans[1:])
    s = profiling.summary()
    parts = sum(s[f"brepgen.train.{k}"]["host_s"] for k in STEP_PARTS)
    assert s["brepgen.train.step"]["self_s"] == pytest.approx(
        s["brepgen.train.step"]["host_s"] - parts, abs=1e-9)


def test_scorers_are_spans_and_return_the_same():
    s, r = _eval_inputs()
    d, cov, jsd = _score(s, r)
    with profiling.recording():
        d2, cov2, jsd2 = _score(s, r)
    np.testing.assert_array_equal(d, d2)
    assert cov == cov2 and jsd == jsd2
    assert [(sp.name, sp.ids) for sp in profiling.spans()] == [
        ("brepgen.eval.chamfer", {"n_s": 6, "n_r": 5}),
        ("brepgen.eval.cov_mmd", {"n_s": 6, "n_r": 5}),
        ("brepgen.eval.jsd", {"n_s": 6, "n_r": 5})]


# --- the trace reader --------------------------------------------------------------------
def test_trace_summary_counts_copies_and_labels_gaps_by_covering_span(tmp_path):
    # a window of 1000 us: a kernel [0, 100), a copy [100, 200), a fill
    # [200, 250) and a kernel [255, 260) (a 5-us launch gap), then idle; the
    # device-side copy of an annotation spans all of it and is no work. The
    # chamfer span covers the first 300 us, the JSD span [300, 980) covers
    # most of the 740-us gap from 260, and a cov_mmd span [262, 300) some of it
    def x(cat, name, ts, dur, tid=1):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid}

    events = [x("cpu_op", "aten::mm", 0.0, 1000.0),
              x("kernel", "chamfer_kernel", 0.0, 100.0, tid=7),
              x("gpu_memcpy", "Memcpy DtoH", 100.0, 100.0, tid=7),
              x("gpu_memset", "Memset", 200.0, 50.0, tid=7),
              x("kernel", "chamfer_kernel", 255.0, 5.0, tid=7),
              x("gpu_user_annotation", "brepgen.eval.chamfer", 0.0, 1000.0, tid=7),
              x("user_annotation", "brepgen.eval.chamfer", 0.0, 300.0),
              x("user_annotation", "brepgen.eval.cov_mmd", 262.0, 38.0),
              x("user_annotation", "brepgen.eval.jsd", 300.0, 680.0),
              x("user_annotation", "brepgen.eval.step", 0.0, 990.0),
              x("user_annotation", "gpubench.eval.metrics", 262.0, 720.0)]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    s = profiling.summarize_trace(str(path))
    assert s["window_ms"] == pytest.approx(1.0) and s["device_busy_ms"] == pytest.approx(0.255)
    assert s["device_idle_share"] == pytest.approx(0.745)
    assert s["kernels"] == 2 and s["device_ops"] == 4
    assert s["top"][0] == ("chamfer_kernel", pytest.approx(0.105), 2)
    assert dict((k, ms) for k, ms, _ in s["idle_gaps"]) == {
        "brepgen.eval.jsd": pytest.approx(0.74), "gaps under 10 us": pytest.approx(0.005)}
    selfs = {k: ms for k, ms, _ in s["spans"]}
    assert selfs["brepgen.eval.jsd"] == pytest.approx(0.68)
    assert selfs["brepgen.eval.step"] == pytest.approx(0.01)
    assert selfs["brepgen.eval.chamfer"] == pytest.approx(0.262)
    line = profiling.format_summary(s)
    assert "device idle share 0.7450" in line
    assert "idle gaps by span: brepgen.eval.jsd 0.7 ms x1" in line
    assert "top spans by self time: brepgen.eval.jsd 0.7 ms x1" in line


@pytest.mark.parametrize("inner,label", [((50.0, 80.0), "brepgen.cascade.update"),
                                         ((50.0, 30.0), "brepgen.cascade.surfpos"),
                                         (None, "outside brepgen spans")])
def test_a_gap_goes_under_the_innermost_span_covering_most_of_it(tmp_path, inner, label):
    # an idle gap [20, 120): the stage span covers all of it; an update span
    # covers 80% of it (its label) or 30% (the stage's)
    events = [{"ph": "X", "cat": "kernel", "name": "k", "ts": 0.0, "dur": 20.0, "tid": 7},
              {"ph": "X", "cat": "kernel", "name": "k", "ts": 120.0, "dur": 10.0, "tid": 7}]
    if inner is not None:
        events += [{"ph": "X", "cat": "user_annotation", "name": "brepgen.cascade.surfpos",
                    "ts": 0.0, "dur": 130.0, "tid": 1},
                   {"ph": "X", "cat": "user_annotation", "name": "brepgen.cascade.update",
                    "ts": inner[0], "dur": inner[1], "tid": 1}]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    s = profiling.summarize_trace(str(path))
    assert s["idle_gaps"] == [(label, pytest.approx(0.1), 1)]


# --- on the card ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_device_span_reads_the_kernels_time():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from brepgen_tpu_torch.kernels.chamfer import chamfer_matrix

    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((256, 2000, 3), generator=gen, device="cuda")
    y = torch.randn((256, 2000, 3), generator=gen, device="cuda")
    chamfer_matrix(x, y)  # build and warm up
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        with profiling.span("brepgen.test.k4", device=True):
            chamfer_matrix(x, y)
        torch.cuda.synchronize()
    span_s = profiling.summary()["brepgen.test.k4"]["device_s"]
    kernel_s = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
                   if e.device_type() == torch.autograd.DeviceType.CUDA
                   and "chamfer" in e.name().lower()) / 1e9
    assert kernel_s > 0
    assert abs(span_s - kernel_s) <= 0.05 * kernel_s, (span_s, kernel_s)
