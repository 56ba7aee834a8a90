"""The readers of the program's spans (``brepgen_tpu_torch.utils.profiling``):
nothing without a trace, an empty recorder or a program without the
recorder; the right value from a recorder filled by hand."""

import importlib.util
from pathlib import Path

import pytest

from brepgen_tpu_torch.utils import profiling

METRICS = Path(__file__).resolve().parents[1] / "metrics"
TRACED = {"trace": {"window_s": 1.0, "busy_s": 0.9}, "window": {}}
MS = 1_000_000  # ns


def reader(name):
    spec = importlib.util.spec_from_file_location(f"reader_{name}", METRICS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def fill(*spans):
    """Spans (name, start ms, end ms, parent, device s) into the recorder."""
    for name, t0, t1, parent, device_s in spans:
        profiling.spans().append(profiling.Span(name, t0 * MS, t1 * MS, parent, {},
                                                device_s=device_s))


@pytest.fixture(autouse=True)
def empty_recorder():
    profiling.reset()
    yield
    profiling.reset()


NAMES = ("update_us.sample", "encode_span_ms.train", "denoiser_ms.train", "optim_ms.train",
         "jsd_host_ms.eval")


@pytest.mark.parametrize("name", NAMES)
def test_nothing_to_read(name, monkeypatch):
    read = reader(name)
    assert read(TRACED) is None  # an empty recorder
    fill(("brepgen.other", 0, 1, -1, 1.0))
    assert read(TRACED) is None  # no span of its names
    assert read({"trace": None, "window": {}}) is None  # no trace (a CPU rehearsal)
    monkeypatch.delattr(profiling, "summary")
    assert read(TRACED) is None  # a program without the recorder


def test_update_us():
    fill(("brepgen.cascade.surfpos", 0, 100, -1, 0.1),
         ("brepgen.cascade.denoise", 0, 10, 0, None),
         ("brepgen.cascade.update", 10, 10.05, 0, None),
         ("brepgen.cascade.update", 20, 20.07, 0, None))
    assert reader("update_us.sample")(TRACED) == pytest.approx(60.0)


def test_train_step_parts():
    def step(t, parent):
        return [("brepgen.train.step", t, t + 930, -1, 0.93),
                ("brepgen.train.encode", t, t + 10, parent, 0.81),
                ("brepgen.train.forward", t + 10, t + 20, parent, 0.04),
                ("brepgen.train.backward", t + 20, t + 30, parent, 0.07),
                ("brepgen.train.optimizer", t + 30, t + 40, parent, 0.006)]
    fill(*step(0, 0), *step(1000, 5))
    assert reader("encode_span_ms.train")(TRACED) == pytest.approx(810.0)
    assert reader("denoiser_ms.train")(TRACED) == pytest.approx(110.0)
    assert reader("optim_ms.train")(TRACED) == pytest.approx(6.0)


def test_a_part_without_device_time_reads_nothing():
    fill(("brepgen.train.step", 0, 10, -1, 0.0), ("brepgen.train.encode", 0, 5, 0, None),
         ("brepgen.train.forward", 5, 6, 0, None), ("brepgen.train.backward", 6, 7, 0, None),
         ("brepgen.train.optimizer", 7, 8, 0, None))
    for name in NAMES[1:4]:
        assert reader(name)(TRACED) is None, name


def test_jsd_host_ms():
    fill(("brepgen.eval.chamfer", 0, 3400, -1, 3.4), ("brepgen.eval.cov_mmd", 3400, 3420, -1, None),
         ("brepgen.eval.jsd", 3420, 4220, -1, None))
    assert reader("jsd_host_ms.eval")(TRACED) == pytest.approx(800.0)
