"""Epoch loop shared by the stages (``brepgen_tpu/train/loop.py``): train
``epochs`` epochs, validate every ``test_nepoch``, write ``epoch_N.npz``
every ``save_nepoch`` and at the end, with a resume file beside it."""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, Iterable, Optional

import torch

from brepgen_tpu_torch.train.checkpoint import save_params_npz, save_resume
from brepgen_tpu_torch.train.common import TrainState
from brepgen_tpu_torch.train.logging import MetricsLogger

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
) -> TrainState:
    """``train_step(state, batch, generator) -> metrics``; ``val_fn(state)
    -> metrics``. Metrics are read back (a device sync) only every
    ``log_every`` steps. The resume file keeps ``generator``'s state beside
    the module, optimizer and step."""
    for epoch in range(1, epochs + 1):
        t0, step0 = time.perf_counter(), state.step
        for batch in make_epoch_iter():
            metrics = train_step(state, batch, generator)
            if (state.step - 1) % log_every == 0:
                logger.log({k: float(v) for k, v in metrics.items()}, state.step - 1)
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # the epoch's time includes its last step
        logger.log({"epoch": epoch, "epoch_steps": state.step - step0,
                    "epoch_seconds": time.perf_counter() - t0}, state.step)
        if val_fn is not None and epoch % test_nepoch == 0:
            logger.log(val_fn(state), state.step)
        if epoch % save_nepoch == 0 or epoch == epochs:
            save_params_npz(ckpt_dir, state.module, f"epoch_{epoch}")
            save_resume(os.path.join(ckpt_dir, RESUME_FILE), state, {"train": generator})
    return state
