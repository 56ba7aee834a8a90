"""Small cells on the CPU for the tests: each workload at the tiny
architecture and sizes a test run holds."""

import torch

from gpubench import control
from gpubench import run as harness

SMALL = {
    "deepcad-sample": {"sampling": {"batch_size": 2, "num_surfaces": 4, "num_edges": 3,
                                    "pndm_steps": 20, "pos_pndm_calls": 15, "ddpm_tail": 8},
                       "mix": {"check_calls": 2}},
    "abc-sample-ddim50": {"sampling": {"batch_size": 2, "num_surfaces": 4, "num_edges": 3},
                          "mix": {"fast_steps": 6, "check_calls": 2}},
    "deepcad-train": {},
    "deepcad-eval": {},
}


F32 = {"deepcad-sample": "sampling", "abc-sample-ddim50": "sampling",
       "deepcad-train": "training"}


def checked(workload: str, seed: int = 2147483659, seconds: float = 0.05):
    """({name: reading}, correct) of a small run of ``workload``, its
    configuration in float32: at the tiny width on the CPU the bf16 readings
    are not the card's, and a fault reads the same in either type."""
    harness.set_cache_dirs()
    overrides = {k: dict(v) for k, v in SMALL[workload].items()}
    if workload in F32:
        overrides.setdefault(F32[workload], {})["dtype"] = "float32"
    run, limits = control.build(workload, seed, "cpu", overrides)
    run.setup()
    run.window(seconds)
    run.release()
    checks = harness.compare(run.readings(), limits)
    return {n: v for n, v, _ in checks}, all(harness.passes(v, lim) for _, v, lim in checks)


def small_readings(workload: str, seed: int):
    return control.readings(workload, seed, 0.05, "cpu", SMALL[workload])


def cpu():
    return torch.device("cpu")
