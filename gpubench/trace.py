"""A device trace of one short steady stretch of a cell, reduced to what the
per-layer metrics read: device busy time within the benchmark's own marks,
device time by operation name, device time under each of the benchmark's
spans, and the idle gaps labelled by what the host was doing. The raw trace
is not kept."""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch

MARK = "gpubench.traced"
SPAN_PREFIX = "gpubench."
TOP = 10
NAME_CHARS = 100
SHORT_GAP_NS = 10_000  # shorter idle gaps are summed under one label


def span(name: str):
    """A benchmark span (``gpubench.<name>``), visible to the trace."""
    return torch.profiler.record_function(SPAN_PREFIX + name)


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _is_device(e, host_names) -> bool:
    """A device activity: a kernel, copy or fill, not the device-side copy
    of a host annotation (a ``record_function`` span such as the
    optimizer's ``Optimizer.step#AdamW.step``), which spans the work
    launched under it, gaps included. Such a copy carries its annotation's
    name, which no kernel, copy or fill shares with a host event; where the
    PyTorch at hand flags annotations, the flag is read as well."""
    if e.device_type() != torch.autograd.DeviceType.CUDA or e.name() in host_names:
        return False
    flag = getattr(e, "is_user_annotation", None)  # not every PyTorch has it
    return not (flag is not None and flag())


def traced(fn: Callable[[], object]) -> Tuple[object, Dict]:
    """Run ``fn`` under the profiler between two synchronisations; return
    its result and the trace's summary (``summarise``)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(MARK):
            out = fn()
            torch.cuda.synchronize()
    return out, summarise(prof.profiler.kineto_results.events())


def summarise(events) -> Dict:
    events = list(events)
    mark = [e for e in events
            if e.name() == MARK and e.device_type() != torch.autograd.DeviceType.CUDA]
    if not mark:
        raise RuntimeError("the trace holds no benchmark mark")
    w0, w1 = mark[0].start_ns(), mark[0].end_ns()
    host = [e for e in events if e.device_type() != torch.autograd.DeviceType.CUDA]
    host_names = {e.name() for e in host}
    device = [e for e in events if _is_device(e, host_names) and e.duration_ns() > 0]
    intervals = [(max(e.start_ns(), w0), min(e.end_ns(), w1)) for e in device]
    busy = _union([(s, e) for s, e in intervals if e > s])
    by_name: Dict[str, float] = defaultdict(float)
    for e in device:
        by_name[e.name()] += e.duration_ns() / 1e9
    # device time under each benchmark span: the device events launched by
    # a runtime call made inside the span
    spans = [e for e in host if e.name().startswith(SPAN_PREFIX) and e.name() != MARK]
    launches = [e for e in host if e.correlation_id() and not e.name().startswith(SPAN_PREFIX)]
    device_by_corr: Dict[int, float] = defaultdict(float)
    for e in device:
        device_by_corr[e.correlation_id()] += e.duration_ns() / 1e9
    span_device: Dict[str, float] = defaultdict(float)
    span_count: Dict[str, int] = defaultdict(int)
    launches.sort(key=lambda e: e.start_ns())
    starts = [e.start_ns() for e in launches]
    for s in spans:
        name = s.name()[len(SPAN_PREFIX):]
        span_count[name] += 1
        i = bisect.bisect_left(starts, s.start_ns())
        while i < len(launches) and launches[i].start_ns() < s.end_ns():
            span_device[name] += device_by_corr.get(launches[i].correlation_id(), 0.0)
            i += 1
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": sum(e - s for s, e in busy) / 1e9,
        "device_s_by_name": dict(by_name),
        "span_device_s": dict(span_device),
        "span_count": dict(span_count),
        "idle_gaps": _gaps(busy, w0, w1, host),
    }


def _gaps(busy, w0, w1, host) -> Dict[str, float]:
    """Idle seconds of the device within the window, summed by a label of
    what the host was doing when each gap began: the innermost benchmark
    span and the innermost host operation that cover that moment. Gaps
    under 10 us, the launch-to-launch gaps of a busy stream, are summed
    under one label."""
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    marks = [(e.start_ns(), e.end_ns(), e.name()[len(SPAN_PREFIX):]) for e in host
             if e.name().startswith(SPAN_PREFIX) and e.name() != MARK]
    ops = sorted(((e.start_ns(), e.end_ns(), e.name()) for e in host
                  if not e.name().startswith(SPAN_PREFIX) and e.end_ns() > e.start_ns()),
                 key=lambda x: x[0])
    starts = [o[0] for o in ops]
    out: Dict[str, float] = defaultdict(float)
    for g0, g1 in gaps:
        if g1 - g0 < SHORT_GAP_NS:
            out["gaps under 10 us"] += (g1 - g0) / 1e9
            continue
        covering = [m for m in marks if m[0] <= g0 < m[1]]
        span_name = min(covering, key=lambda m: m[1] - m[0])[2] if covering else ""
        i = bisect.bisect_right(starts, g0)
        near = [o for o in ops[max(0, i - 64):i] if o[1] > g0]
        op_name = min(near, key=lambda o: o[1] - o[0])[2] if near else ""
        label = " > ".join(x for x in (span_name, op_name) if x) or "host idle"
        out[label[:NAME_CHARS]] += (g1 - g0) / 1e9
    return dict(out)


def breakdown(summary: Dict) -> Dict[str, list]:
    """The result line's ``breakdown``: the ten device operations of most
    time, the ten idle-gap labels of most time."""
    def top(d):
        return [[k[:NAME_CHARS], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return {"device_ops": top(summary["device_s_by_name"]), "idle_gaps": top(summary["idle_gaps"])}


def device_seconds(summary: Dict, patterns) -> float:
    """Summed device time of the operations whose name holds any of
    ``patterns``."""
    return sum(v for k, v in summary["device_s_by_name"].items()
               if any(p in k for p in patterns))



def idle_percent(summary) -> float | None:
    """The device's idle share of a traced stretch, in percent: the time
    between the benchmark's marks with no device activity, over the span."""
    if summary is None or summary["window_s"] <= 0:
        return None
    return (summary["window_s"] - summary["busy_s"]) / summary["window_s"] * 100.0


def roofline_percent(summary, ops_key: str, bytes_key: str, kernels) -> float | None:
    """The least time of the work in ``summary["work"]`` (the larger of
    operations over the peak and bytes over the bandwidth) over the device
    time of ``kernels``, in percent; None where the trace has neither."""
    from gpubench.counts import bound_s

    if summary is None or ops_key not in summary.get("work", {}):
        return None
    seconds = device_seconds(summary, kernels)
    if seconds <= 0:
        return None
    w = summary["work"]
    return bound_s(w[ops_key], w[bytes_key], w["dtype"]) / seconds * 100.0
