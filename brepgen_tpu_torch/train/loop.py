"""Epoch loop shared by the LDM stages and the VAEs (``brepgen_tpu/train/loop.py``
and the loops of ``brepgen_tpu/cli/{ldm,vae}_main.py``): train ``epochs``
epochs, print ms per step over every 100-step window, validate every
``test_nepoch``, write ``epoch_N.npz`` every ``save_nepoch`` and at the end,
with a resume file beside it. Under a process group (data parallelism) rank
0 alone writes them, from the unwrapped module (npz keys without DDP's
``module.`` prefix), and every rank waits for the write."""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, Iterable, Optional

import torch

from brepgen_tpu_torch.parallel.distributed import barrier, rank_and_world
from brepgen_tpu_torch.train.checkpoint import save_params_npz, save_resume
from brepgen_tpu_torch.train.common import TrainState
from brepgen_tpu_torch.train.logging import MetricsLogger
from brepgen_tpu_torch.utils.profiling import StepTrace

RESUME_FILE = "latest.pt"


def run_training(
    train_step: Callable,
    make_epoch_iter: Callable[[], Iterable],
    state: TrainState,
    *,
    epochs: int,
    generator: torch.Generator,
    logger: MetricsLogger,
    ckpt_dir: str,
    val_fn: Optional[Callable[[TrainState], Dict]] = None,
    test_nepoch: int = 10,
    save_nepoch: int = 20,
    log_every: int = 10,
    trace: Optional[StepTrace] = None,
) -> TrainState:
    """``train_step(state, batch, generator) -> metrics``; ``val_fn(state)
    -> metrics``. Metrics are read back (a device sync) only every
    ``log_every`` steps, which bounds how far the host runs ahead of the
    device in the 100-step windows (the first window holds the warm-up). The
    resume file keeps ``generator``'s state beside the module, optimizer and
    step. ``trace`` (``--profile``) is told of every step and epoch end.
    ``state.module`` is the unwrapped module; under a process group pass
    rank 0 the logger and the others a logger that drops what it is given
    (the metrics are global), and only rank 0 prints."""
    main = rank_and_world()[0] == 0
    t_window = None
    for epoch in range(1, epochs + 1):
        t0, step0 = time.perf_counter(), state.step
        for batch in make_epoch_iter():
            if trace is not None:
                trace.before_step(state.step)
            metrics = train_step(state, batch, generator)
            if trace is not None:
                trace.after_step(state.step)
            if (state.step - 1) % log_every == 0:
                logger.log({k: float(v) for k, v in metrics.items()}, state.step - 1)
            if state.step % 100 == 0:
                now = time.perf_counter()
                if t_window is not None and main:
                    dt = (now - t_window) / 100
                    print(f"step {state.step}: {dt * 1e3:.1f} ms/step ({1 / dt:.2f} steps/s)",
                          flush=True)
                t_window = now
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # the epoch's time includes its last step
        logger.log({"epoch": epoch, "epoch_steps": state.step - step0,
                    "epoch_seconds": time.perf_counter() - t0}, state.step)
        if trace is not None:
            trace.end_epoch()  # after the epoch's time: writing the trace is not a step
        if val_fn is not None and epoch % test_nepoch == 0:
            logger.log(val_fn(state), state.step)
        if epoch % save_nepoch == 0 or epoch == epochs:
            if main:
                save_params_npz(ckpt_dir, state.module, f"epoch_{epoch}")
                save_resume(os.path.join(ckpt_dir, RESUME_FILE), state, {"train": generator})
            barrier()
    return state
