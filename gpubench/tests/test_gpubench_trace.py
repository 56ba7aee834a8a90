"""The trace's reduction on made-up events: busy time within the marks,
device time by name and under spans, idle gaps by what the host did, and
device-side copies of host annotations left out."""

import torch

from gpubench import trace

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


class Ev:
    def __init__(self, name, dev, start, end, corr=0):
        self._n, self._d, self._s, self._e, self._c = name, dev, start, end, corr

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def duration_ns(self):
        return self._e - self._s

    def correlation_id(self):
        return self._c


def test_summarise():
    us = 1000
    events = [
        Ev(trace.MARK, CPU, 0, 1000 * us),
        Ev("gpubench.stage", CPU, 10 * us, 600 * us),
        Ev("gpubench.inner", CPU, 15 * us, 30 * us),        # nested: both count
        Ev("cudaLaunchKernel", CPU, 20 * us, 25 * us, corr=1),
        Ev("cudaLaunchKernel", CPU, 700 * us, 705 * us, corr=2),
        Ev("aten::copy_", CPU, 610 * us, 690 * us),
        Ev("gpubench.stage", CUDA, 30 * us, 500 * us),      # the annotation's copy
        Ev("Optimizer.step#AdamW.step", CPU, 650 * us, 720 * us),
        Ev("Optimizer.step#AdamW.step", CUDA, 600 * us, 905 * us),  # its copy spans a gap
        Ev("kernel_a", CUDA, 30 * us, 230 * us, corr=1),
        Ev("kernel_a", CUDA, 232 * us, 236 * us, corr=1),
        Ev("kernel_b", CUDA, 700 * us, 900 * us, corr=2),
    ]
    s = trace.summarise(events)
    assert s["window_s"] == 1e-3
    assert abs(s["busy_s"] - 404e-6) < 1e-12
    assert abs(s["device_s_by_name"]["kernel_a"] - 204e-6) < 1e-12
    assert "gpubench.stage" not in s["device_s_by_name"]
    assert "Optimizer.step#AdamW.step" not in s["device_s_by_name"]
    assert abs(s["span_device_s"]["stage"] - 204e-6) < 1e-12
    assert abs(s["span_device_s"]["inner"] - 204e-6) < 1e-12
    gaps = s["idle_gaps"]
    assert abs(sum(gaps.values()) - (1e-3 - 404e-6)) < 1e-12
    assert abs(gaps["gaps under 10 us"] - 2e-6) < 1e-12
    assert abs(gaps["stage"] - 464e-6) < 1e-12          # 236-700 us: the span, no host op
    assert abs(gaps["host idle"] - 130e-6) < 1e-12      # 0-30 and 900-1000 us
    b = trace.breakdown(s)
    assert b["device_ops"][0] == ["kernel_a", 204e-6] and len(b["idle_gaps"]) <= trace.TOP


def test_device_seconds():
    s = {"device_s_by_name": {"void packed_attention_wgmma_kernel<64>": 2.0, "other": 1.0}}
    assert trace.device_seconds(s, ("packed_attention_wgmma_kernel",)) == 2.0


class Flagged(Ev):
    def __init__(self, *a, annotation=False, **k):
        super().__init__(*a, **k)
        self._a = annotation

    def is_user_annotation(self):
        return self._a


def test_flagged_annotation_is_left_out():
    """Where the events carry PyTorch's annotation flag, a device-side
    annotation whose host half fell outside the trace is left out too."""
    us = 1000
    events = [
        Flagged(trace.MARK, CPU, 0, 100 * us),
        Flagged("cudaLaunchKernel", CPU, 5 * us, 6 * us, corr=1),
        Flagged("outer", CUDA, 0, 100 * us, annotation=True),
        Flagged("kernel_a", CUDA, 10 * us, 40 * us, corr=1),
    ]
    s = trace.summarise(events)
    assert abs(s["busy_s"] - 30e-6) < 1e-12 and list(s["device_s_by_name"]) == ["kernel_a"]
