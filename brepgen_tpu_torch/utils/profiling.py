"""Tracing and profiling hooks.

Port of ``brepgen_tpu/utils/profiling.py`` (the reference has none), with the
port's span recorder:

- ``span(name, device=False, **ids)`` marks a block of the program, named
  ``brepgen.<layer>.<what>``. Tracing is off by default: a span then costs
  one check and returns a shared no-op context. It is on while a
  ``torch.profiler`` records (``--profile``, the benchmark's traced
  stretch) and inside ``recording()``. A span then emits
  ``record_function(name)``, so that it lands in the device trace on the
  kernels' timeline, and appends a ``Span`` to the recorder: its name, its
  start and end on the profiler's clock (epoch nanoseconds, as kineto's
  ``start_ns()``), the index of its parent (the innermost span open in its
  thread) and its ids. With ``device=True`` on a card it also records a
  pair of CUDA events on the current stream, unless the stream is
  capturing a graph. ``summary()`` reads the recorder by span name;
  ``reset()`` clears it, as starting a trace does.
- ``StageTimer`` collects wall-clock seconds per named stage, synchronising
  on the card where a stage hands it a tensor; each stage is a span.
- ``device_trace`` wraps a block in a ``torch.profiler`` trace (CPU and, on
  a card, CUDA activities) written as a Chrome trace into a directory, and
  is a no-op without one. ``StepTrace`` is the ``--profile`` window of the
  training loop (``brepgen_tpu/cli/ldm_main.py:376-398``): it starts before
  step 10 and stops after step 29 or at the end of that epoch,
  synchronised.
- ``summarize_trace`` reads a written trace: the traced window, the device
  busy time (the union of the kernels, copies and fills; the device-side
  copies of host annotations span the work under them and are left out),
  the device idle share, the device operations of most time, the idle gaps
  each under the ``brepgen.*`` span that covers most of it, and the spans
  of most self time.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import os
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

TRACE_FILE = "trace.json"
# the --profile window of the JAX CLI: from step 10 until 30 steps are done
TRACE_FIRST_STEP, TRACE_STOP_STEP = 10, 30
TOP_OPS = 5
SPAN_PREFIX = "brepgen."
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")  # Chrome trace categories
SHORT_GAP_US = 10.0  # idle gaps under this are launch gaps of a busy stream
SHORT_GAP_LABEL = "gaps under 10 us"
NO_SPAN_LABEL = "outside brepgen spans"


@dataclasses.dataclass
class Span:
    """One recorded block: times in epoch nanoseconds (``end_ns`` None while
    open), ``parent`` the index of the enclosing span (-1 at the top),
    ``device_s`` the device-stream seconds between its CUDA events once
    ``summary()`` has resolved them."""

    name: str
    start_ns: int
    end_ns: Optional[int]
    parent: int
    ids: Dict[str, object]
    device_s: Optional[float] = None
    events: Optional[Tuple["torch.cuda.Event", "torch.cuda.Event"]] = None


class Recorder:
    """The spans of one recording, appended in the order they open."""

    def __init__(self):
        self.spans: List[Span] = []
        self.explicit = 0  # depth of open ``recording()`` blocks
        self.offset_ns = time.time_ns() - time.perf_counter_ns()
        self.lock = threading.Lock()
        self.local = threading.local()

    def reset(self) -> None:
        """Start a new recording: no spans, a fresh clock offset. Spans
        still open carry over as no one's parent."""
        with self.lock:
            self.spans = []
            self.offset_ns = time.time_ns() - time.perf_counter_ns()

    def now_ns(self) -> int:
        return time.perf_counter_ns() + self.offset_ns

    def stack(self) -> List[Tuple[List[Span], int]]:
        """This thread's open spans, innermost last: (their list, index)."""
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per span name: ``count``, ``host_s`` (summed durations),
        ``self_s`` (durations less the time their children cover) and
        ``device_s`` (summed device-stream seconds of the spans with CUDA
        events; 0 without). Open spans are left out. Synchronises the card
        where event pairs wait to be read."""
        spans = list(self.spans)
        if any(s.events is not None for s in spans):
            torch.cuda.synchronize()
        children = [0] * len(spans)
        for s in spans:
            if s.end_ns is not None and 0 <= s.parent < len(spans):
                children[s.parent] += s.end_ns - s.start_ns
        out: Dict[str, Dict[str, float]] = {}
        for s, child_ns in zip(spans, children):
            if s.end_ns is None:
                continue
            if s.events is not None:
                s.device_s = s.events[0].elapsed_time(s.events[1]) / 1e3
                s.events = None
            d = out.setdefault(s.name, {"count": 0, "host_s": 0.0, "self_s": 0.0,
                                        "device_s": 0.0})
            host_ns = s.end_ns - s.start_ns
            d["count"] += 1
            d["host_s"] += host_ns / 1e9
            d["self_s"] += (host_ns - child_ns) / 1e9
            d["device_s"] += s.device_s or 0.0
        return out


RECORDER = Recorder()
_OFF = contextlib.nullcontext()
_profiler_enabled = torch._C._autograd._profiler_enabled


class _Open:
    """The context of a span while tracing is on."""

    __slots__ = ("recorder", "name", "device", "ids", "span", "function")

    def __init__(self, recorder: Recorder, name: str, device: bool, ids: Dict[str, object]):
        self.recorder, self.name, self.device, self.ids = recorder, name, device, ids

    def __enter__(self) -> Span:
        rec = self.recorder
        self.function = torch.profiler.record_function(self.name)
        self.function.__enter__()
        events = None
        if (self.device and torch.cuda.is_available() and torch.cuda.is_initialized()
                and not torch.cuda.is_current_stream_capturing()):
            events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            events[0].record()
        stack = rec.stack()
        with rec.lock:
            spans = rec.spans
            parent = -1
            if stack:
                top = stack[-1][0]
                parent = stack[-1][1] if top is spans else -1
            self.span = Span(self.name, rec.now_ns(), None, parent, self.ids, events=events)
            stack.append((spans, len(spans)))
            spans.append(self.span)
        return self.span

    def __exit__(self, *exc) -> None:
        span = self.span
        if span.events is not None:
            span.events[1].record()
        span.end_ns = self.recorder.now_ns()
        self.recorder.stack().pop()
        self.function.__exit__(*exc)


def span(name: str, device: bool = False, **ids):
    """A context for the block ``name``; with tracing on it records a
    ``Span`` (and, with ``device``, a CUDA event pair on the current
    stream), with tracing off it does nothing."""
    if not (RECORDER.explicit or _profiler_enabled()):
        return _OFF
    return _Open(RECORDER, name, device, ids)


@contextlib.contextmanager
def recording():
    """Tracing on for the block, without a profiler; the outermost block
    starts a new recording."""
    if not RECORDER.explicit:
        RECORDER.reset()
    RECORDER.explicit += 1
    try:
        yield RECORDER
    finally:
        RECORDER.explicit -= 1


def summary() -> Dict[str, Dict[str, float]]:
    """``Recorder.summary`` of the current recording."""
    return RECORDER.summary()


def spans() -> List[Span]:
    """The current recording's spans (the recorder's own list)."""
    return RECORDER.spans


def reset() -> None:
    RECORDER.reset()


class StageTimer:
    """Accumulates wall-clock seconds per stage name."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, block_on: Optional[torch.Tensor] = None):
        """Time the block, a span ``name``; with ``block_on`` on a card, the
        time runs until the card has finished the work queued in the
        block."""
        t0 = time.perf_counter()
        try:
            with span(name):
                yield
        finally:
            if block_on is not None and block_on.is_cuda:
                torch.cuda.synchronize(block_on.device)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"total_s": self.totals[k], "count": self.counts[k],
                "mean_s": self.totals[k] / max(self.counts[k], 1)}
            for k in self.totals
        }

    def report(self) -> str:
        lines = []
        for k, v in sorted(self.summary().items(), key=lambda kv: -kv[1]["total_s"]):
            lines.append(f"{k:>24s}: {v['total_s']:8.2f}s total, {v['mean_s'] * 1e3:8.1f}ms "
                         f"avg x{v['count']}")
        return "\n".join(lines)


def start_trace() -> "torch.profiler.profile":
    """A running profiler over the CPU and, where there is a card, CUDA; the
    span recorder starts a new recording with it."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    reset()
    prof.start()
    return prof


def stop_trace(prof: "torch.profiler.profile", log_dir: str) -> str:
    """Synchronise the card, stop ``prof`` and write its Chrome trace to
    ``log_dir/trace.json``; returns the path."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """torch.profiler trace of the block into ``log_dir``; no-op for None."""
    if log_dir is None:
        yield
        return
    prof = start_trace()
    try:
        yield
    finally:
        stop_trace(prof, log_dir)


class StepTrace:
    """The training loop's ``--profile`` window: ``before_step`` starts the
    trace at step 10; ``after_step`` stops it once 30 steps are done,
    ``end_epoch`` at the end of the epoch it started in. One window per
    run."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self.first_step = self.last_step = None
        self.path: Optional[str] = None
        self._prof = None

    def before_step(self, step: int) -> None:
        if self._prof is None and self.path is None and step == TRACE_FIRST_STEP:
            self._prof = start_trace()
            self.first_step = step

    def after_step(self, step: int) -> None:
        """``step``: the count of steps done."""
        if self._prof is not None:
            self.last_step = step - 1
            if step >= TRACE_STOP_STEP:
                self._close()

    def end_epoch(self) -> None:
        if self._prof is not None:
            self._close()

    def _close(self) -> None:
        self.path = stop_trace(self._prof, self.log_dir)
        self._prof = None
        summary = summarize_trace(self.path)
        print(f"profile: steps {self.first_step}-{self.last_step}: {format_summary(summary)}; "
              f"trace {self.path}", flush=True)


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _self_times(spans: List[dict]) -> Dict[str, List[float]]:
    """Per span name: [self us, count], self time being the duration less
    the time its children (spans nested in it on its thread) cover."""
    by_thread: Dict[object, List[dict]] = defaultdict(list)
    for e in spans:
        by_thread[(e.get("pid"), e.get("tid"))].append(e)
    out: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for events in by_thread.values():
        events.sort(key=lambda e: (float(e["ts"]), -float(e["dur"])))
        stack: List[Tuple[float, str]] = []  # (end, name) of the open spans
        for e in events:
            s, d = float(e["ts"]), float(e["dur"])
            while stack and stack[-1][0] <= s:
                stack.pop()
            if stack:
                out[stack[-1][1]][0] -= d
            out[e["name"]][0] += d
            out[e["name"]][1] += 1
            stack.append((s + d, e["name"]))
    return out


def _gap_labels(gaps: List[Tuple[float, float]], spans: List[dict]) -> Dict[str, List[float]]:
    """Per label: [idle us, count] of the gaps. A gap of 10 us or more goes
    under the innermost ``brepgen.*`` span that covers more than half of
    it, else under the span that covers most of it; shorter gaps go under
    one label."""
    marks = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in spans)
    starts = [m[0] for m in marks]
    out: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    active: List[Tuple[float, float, str]] = []
    j = 0
    for g0, g1 in gaps:
        width = g1 - g0
        if width < SHORT_GAP_US:
            label = SHORT_GAP_LABEL
        else:
            k = bisect.bisect_left(starts, g1)
            active = [m for m in active + marks[j:k] if m[1] > g0]
            j = max(j, k)
            cover = [(min(e, g1) - max(s, g0), e - s, name) for s, e, name in active]
            most = [c for c in cover if c[0] > width / 2]
            if most:
                label = min(most, key=lambda c: c[1])[2]
            elif cover:
                label = max(cover, key=lambda c: c[0])[2]
            else:
                label = NO_SPAN_LABEL
        out[label][0] += width
        out[label][1] += 1
    return out


def summarize_trace(path: str) -> Dict:
    """window_ms (first to last event of the trace), device_busy_ms (union
    of the kernels, copies and fills), device_idle_share (None without
    device activity), kernels (the count of kernel events), device_ops (of
    device activities), top: the five device operations of the largest
    summed time, each (name, ms, count); idle_gaps: the five labels of most
    idle time (``_gap_labels``), each (label, ms, count); spans: the five
    ``brepgen.*`` spans of most self time, each (name, ms, count)."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    if not events:
        raise ValueError(f"{path}: no events in the trace")
    t0 = min(float(e["ts"]) for e in events)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in events)
    device = [e for e in events if e.get("cat") in DEVICE_CATEGORIES]
    busy = _merge([(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in device])
    gaps, t = [], t0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t1 > t:
        gaps.append((t, t1))
    by_name: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for e in device:
        by_name[e["name"]][0] += float(e["dur"])
        by_name[e["name"]][1] += 1
    spans = [e for e in events
             if e.get("cat") == "user_annotation" and e["name"].startswith(SPAN_PREFIX)]

    def ranked(d):
        top = sorted(d.items(), key=lambda kv: -kv[1][0])[:TOP_OPS]
        return [(name, us / 1e3, int(n)) for name, (us, n) in top]

    window = t1 - t0
    busy_us = sum(e - s for s, e in busy)
    return {
        "window_ms": window / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": (1.0 - busy_us / window) if device else None,
        "kernels": sum(e.get("cat") == "kernel" for e in events),
        "device_ops": len(device),
        "top": ranked(by_name),
        "idle_gaps": ranked(_gap_labels(gaps, spans)) if device else [],
        "spans": ranked(_self_times(spans)),
    }


def format_summary(summary: Dict) -> str:
    """One line: window, busy time, idle share, the top device ops, the idle
    gaps by span and the spans of most self time."""
    def listed(rows):
        return "; ".join(f"{name[:60]} {ms:.1f} ms x{n}" for name, ms, n in rows) or "none"

    spans = f"top spans by self time: {listed(summary.get('spans', []))}"
    if summary["device_idle_share"] is None:
        return f"window {summary['window_ms']:.1f} ms; no device activity in the trace; {spans}"
    return (f"window {summary['window_ms']:.1f} ms, device busy {summary['device_busy_ms']:.1f} "
            f"ms, device idle share {summary['device_idle_share']:.4f}; top device ops: "
            f"{listed(summary['top'])}; idle gaps by span: {listed(summary['idle_gaps'])}; "
            f"{spans}")
