"""Metrics as JSON lines (``brepgen_tpu/train/logging.py`` without wandb)."""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricsLogger:
    """Appends one JSON object per call to ``<log_dir>/<name>.jsonl``."""

    def __init__(self, log_dir: str, name: str = "train"):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{name}.jsonl")
        self._fh = open(self.path, "a")

    def log(self, metrics: Dict, step: int) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class NullLogger:
    """A logger that keeps nothing: the ranks other than 0 of a process group."""

    path = ""

    def log(self, metrics: Dict, step: int) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass
