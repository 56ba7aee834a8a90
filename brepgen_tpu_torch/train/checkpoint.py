"""Checkpoints: npz weight packs both packages load, and a resume file.

Port of ``brepgen_tpu/train/checkpoint.py``. ``save_params_npz`` writes the
format of ``checkpoint.py:50-73``: one compressed ``.npz`` with keys
``params/<flax path>`` and f32 values, the layout the JAX package's
``load_params`` reads (built on ``weights.to_flax_params``). orbax is on
neither machine, so the resume state (module, optimizer, step, generator
states) is one ``torch.save`` file.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch
from torch import nn

from brepgen_tpu_torch.train.common import TrainState
from brepgen_tpu_torch.weights import flatten_params, load_flax_params, to_flax_params


def save_params_npz(ckpt_dir: str, module: nn.Module, name: str) -> str:
    """Write ``<ckpt_dir>/<name>.npz`` and return its path."""
    flat = {"params/" + k: v.astype(np.float32)
            for k, v in flatten_params(to_flax_params(module)).items()}
    path = os.path.abspath(os.path.join(ckpt_dir, name + ".npz"))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, **flat)
    return path


def load_params(path: str, module: nn.Module) -> nn.Module:
    """Load an ``.npz`` pack (the extension may be left off) into ``module``,
    strictly."""
    npz = path if path.endswith(".npz") else path + ".npz"
    if not os.path.isfile(npz):
        raise FileNotFoundError(f"{npz}: no npz weight pack (orbax directories are not read)")
    return load_flax_params(module, npz)


def save_resume(path: str, state: TrainState,
                generators: Dict[str, torch.Generator]) -> str:
    """Module, optimizer, step and generator states in one file."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save({
        "module": state.module.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "step": state.step,
        "generators": {k: g.get_state() for k, g in generators.items()},
    }, tmp)
    os.replace(tmp, path)
    return path


def load_resume(path: str, state: TrainState,
                generators: Dict[str, torch.Generator]) -> TrainState:
    """Restore what ``save_resume`` wrote into ``state`` and ``generators``."""
    saved = torch.load(path, map_location="cpu", weights_only=True)
    state.module.load_state_dict(saved["module"])
    state.optimizer.load_state_dict(saved["optimizer"])
    state.step = int(saved["step"])
    for k, g in generators.items():
        g.set_state(saved["generators"][k])
    return state
