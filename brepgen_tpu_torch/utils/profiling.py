"""Tracing and profiling hooks.

Port of ``brepgen_tpu/utils/profiling.py`` (the reference has none):
``StageTimer`` collects wall-clock seconds per named stage, synchronising on
the card where a stage hands it a tensor; ``device_trace`` wraps a block in a
``torch.profiler`` trace (CPU and, on a card, CUDA activities) written as a
Chrome trace into a directory, and is a no-op without one. ``StepTrace`` is
the ``--profile`` window of the training loop (``brepgen_tpu/cli/ldm_main.py:
376-398``): it starts before step 10 and stops after step 29 or at the end of
that epoch, synchronised. ``summarize_trace`` reads a written trace: the
traced window, the device busy time (the union of the CUDA kernel
intervals), the device idle share and the device operations that took most
of the busy time.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

TRACE_FILE = "trace.json"
# the --profile window of the JAX CLI: from step 10 until 30 steps are done
TRACE_FIRST_STEP, TRACE_STOP_STEP = 10, 30
TOP_OPS = 5


class StageTimer:
    """Accumulates wall-clock seconds per stage name."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, block_on: Optional[torch.Tensor] = None):
        """Time the block; with ``block_on`` on a card, the time runs until
        the card has finished the work queued in the block."""
        t0 = time.perf_counter()
        try:
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
    """A running profiler over the CPU and, where there is a card, CUDA."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
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


def _union_us(intervals: List[tuple]) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def summarize_trace(path: str) -> Dict:
    """window_ms (first to last event of the trace), device_busy_ms (union
    of the CUDA kernel intervals), device_idle_share (None without kernel
    events), kernels (the count of kernel events) and top: the five kernel
    names of the largest summed time, each (name, ms, count)."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    if not events:
        raise ValueError(f"{path}: no events in the trace")
    t0 = min(float(e["ts"]) for e in events)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in events)
    kernels = [e for e in events if e.get("cat") == "kernel"]
    busy = _union_us([(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in kernels])
    by_name: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e["name"]][0] += float(e["dur"])
        by_name[e["name"]][1] += 1
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP_OPS]
    window = t1 - t0
    return {
        "window_ms": window / 1e3,
        "device_busy_ms": busy / 1e3,
        "device_idle_share": (1.0 - busy / window) if kernels else None,
        "kernels": len(kernels),
        "top": [(name, us / 1e3, int(n)) for name, (us, n) in ranked],
    }


def format_summary(summary: Dict) -> str:
    """One line: window, busy time, idle share and the top device ops."""
    if summary["device_idle_share"] is None:
        return f"window {summary['window_ms']:.1f} ms; no device kernels in the trace"
    top = "; ".join(f"{name[:60]} {ms:.1f} ms x{n}" for name, ms, n in summary["top"])
    return (f"window {summary['window_ms']:.1f} ms, device busy {summary['device_busy_ms']:.1f} "
            f"ms, device idle share {summary['device_idle_share']:.4f}; top device ops: {top}")
