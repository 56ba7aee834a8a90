"""One run of one benchmark cell of ``BENCHMARK.json``, on the card::

    python3 -m gpubench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell names a configuration (``gpubench/configs/<config>.json``) and a
traffic mix (``gpubench/mixes/<traffic>.json``); the mix's ``kind`` names the
driver (``gpubench/kinds/<kind>.py``) that sets the cell up, runs its window
and checks what the window produced against the plain reference, with the
limits of ``gpubench/limits/<cell>.json``. With ``--trace 1`` the run also
traces one short steady stretch and reports the cell's per-layer metrics,
each read by ``gpubench/metrics/<metric>.py``; with ``--trace 0`` it reports
the cell's end-to-end metrics. The last line of standard output is one JSON
object; the numbers compared, each beside its limit, close standard error
and the line.

A run exits non-zero and prints no result without a CUDA card (or with
fewer than the cell asks for), and when ``jax``, ``jaxlib``, ``flax`` or
the JAX package is loaded once the window has closed. ``--device cpu``
rehearses a cell on the CPU at the tiny architecture: its line says
``"platform": "cpu"`` and carries no device-trace metric.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "gpubench"
FORBIDDEN = ("jax", "jaxlib", "flax", "brepgen_tpu")


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed place inside the checkout."""
    os.environ["BREPGEN_TORCH_BUILD_DIR"] = str(ROOT / "build" / "torch_kernels")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_json(*parts) -> dict:
    with open(HERE.joinpath(*parts)) as f:
        return json.load(f)


def load_reader(name: str):
    """``gpubench/metrics/<name>.py``'s ``read``."""
    spec = importlib.util.spec_from_file_location(f"gpubench_metric_{len(sys.modules)}",
                                                  HERE / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metrics a run of ``cell`` reports: its end-to-end metrics, or with
    ``trace`` its per-layer metrics (those listing the cell, and those
    without a list in every cell that reports the metric they move)."""
    def applies(m):
        return cell in m["workloads"] if "workloads" in m else True

    e2e = [m for m in bench["end_to_end"] if applies(m)]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in moved)]


def power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def passes(value, limit) -> bool:
    return value is not None and not math.isnan(value) and value <= limit


def compare(readings: dict, limits: dict) -> list:
    """[(name, reading, limit)] of every number the cell's limits name."""
    return [(name, readings[name], limit) for name, limit in limits.items()]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cpu: a rehearsal at the tiny architecture, never a measurement")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    set_cache_dirs()
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}; one of {sorted(cells)}", file=sys.stderr)
        return 2
    cell = cells[args.workload]
    config = load_json("configs", f"{cell['config']}.json")
    mix = load_json("mixes", f"{cell['traffic']}.json")
    limits = load_json("limits", f"{cell['name']}.json")

    import torch

    on_card = args.device == "cuda"
    if on_card:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"cell {cell['name']} needs {cell['chips']} CUDA card(s); "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} present",
                  file=sys.stderr)
            return 2
        print(f"card: {power_limit()}", file=sys.stderr, flush=True)
    kind = importlib.import_module(f"gpubench.kinds.{mix['kind']}")
    run = kind.Run(config, mix, args.seed, torch.device(args.device))
    run.setup()
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T0
    print(f"setup: {setup_s:.3f} s", file=sys.stderr, flush=True)

    window = run.window(args.seconds)
    summary = run.traced() if args.trace and on_card else None
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package are loaded: {found}", file=sys.stderr)
        return 3
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    run.release()
    checks = compare(run.readings(), limits)

    values = {"setup_s": setup_s, **window["metrics"]}
    records = {"window": window["records"], "trace": summary, "config": config, "mix": mix,
               "cell": cell["name"]}
    metrics = {}
    for m in cell_metrics(bench, cell["name"], bool(args.trace)):
        value = load_reader(m["name"])(records) if args.trace else values.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
              "count": cell["chips"], "memory_peak_bytes": peak}
    if summary is not None:
        device.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package are loaded: {found}", file=sys.stderr)
        return 3
    correct = all(passes(v, lim) for _, v, lim in checks)
    result = {"correct": correct, "attempted": window["attempted"], "failed": window["failed"],
              "metrics": metrics, "device": device}
    if summary is not None:
        from gpubench.trace import breakdown
        result["breakdown"] = breakdown(summary)
    if not on_card:
        result["rehearsal"] = True
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    print(json.dumps(result), flush=True)
    for name, v, lim in checks:
        print(f"check {name}: {v!r} limit {lim!r} {'ok' if passes(v, lim) else 'FAILED'}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
