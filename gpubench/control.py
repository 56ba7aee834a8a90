"""The readings that a cell's limits are set from, for several seeds::

    python3 -m gpubench.control --workload <cell> --seeds 11 12 13 [--seconds 1]

For each seed it sets the cell up, runs a short window at the cell's own
load, and prints one JSON line with two sets of readings of the numbers the
check compares: the program's, and the control's, in which the reference
in the next precision below the configuration's (fp8 for bf16, TF32 for
f32) stands where the program computes. Benchmark runs never run it;
``gpubench/tests/test_gpubench_control.py`` runs it at a small size on the CPU.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys

import torch

from gpubench import run as harness


def build(workload: str, seed: int, device: str = "cuda", overrides=None):
    """The cell's driver, with ``overrides`` ({"mix" or a configuration
    section: {key: value}}) applied, and the cell's limits."""
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in bench["workloads"]}[workload]
    config = harness.load_json("configs", f"{cell['config']}.json")
    mix = harness.load_json("mixes", f"{cell['traffic']}.json")
    for section, values in (overrides or {}).items():
        (mix if section == "mix" else config[section]).update(values)
    kind = importlib.import_module(f"gpubench.kinds.{mix['kind']}")
    limits = harness.load_json("limits", f"{workload}.json")
    return kind.Run(config, mix, seed, torch.device(device)), limits


def readings(workload: str, seed: int, seconds: float, device: str = "cuda",
             overrides=None) -> dict:
    run, _ = build(workload, seed, device, overrides)
    run.setup()
    run.window(seconds)
    run.release()
    out = {"workload": workload, "seed": seed, "program": run.readings(False),
           "control": run.readings(True)}
    if hasattr(run, "still"):  # elements the training check leaves out, by leaf
        out["left_out"] = run.still
    if hasattr(run, "look"):  # the worst leaves of each side
        out["look"] = run.look
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    harness.set_cache_dirs()
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed, args.seconds)),
              flush=True)
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
