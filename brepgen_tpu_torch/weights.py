"""Carry JAX (flax) parameters over into the port's modules.

Accepts a nested flax tree (``{"params": {...}}`` or the inner dict), a flat
``{"params/<path>": array}`` mapping as ``train/checkpoint.py:save_params_npz``
writes it, or the path of such an ``.npz`` pack. The port's modules carry the
flax names, so a flax path ``a/b/leaf`` becomes the state-dict key ``a.b.<leaf>``
with the layouts turned round (the inverse of ``tools/convert_torch.py``):

  Dense ``kernel`` [in, out]          -> ``weight`` [out, in]
  Conv ``kernel`` WIO / HWIO          -> ``weight`` OIW / OIHW
  LayerNorm/GroupNorm ``scale``       -> ``weight``
  Embed ``embedding``                 -> ``weight``

Loading is strict: a missing or unexpected key, or a shape that differs,
raises. ``to_flax_params`` goes the other way, for the JAX package to read
the port's weights.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "embedding": "weight", "bias": "bias"}


def flatten_params(params: Mapping[str, Any] | str | os.PathLike) -> Dict[str, np.ndarray]:
    """Any accepted form -> {"a/b/leaf": np.ndarray} without the "params/" root."""
    if isinstance(params, (str, os.PathLike)):
        with np.load(params) as raw:
            params = {k: raw[k] for k in raw.files}
    flat: Dict[str, np.ndarray] = {}

    def walk(prefix, node):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(f"{prefix}/{k}" if prefix else str(k), v)
        else:
            flat[prefix] = np.asarray(node)

    walk("", params)
    if flat and all(k.startswith("params/") for k in flat):
        flat = {k[len("params/"):]: v for k, v in flat.items()}
    return flat


def convert_leaf(leaf: str, value: np.ndarray) -> tuple[str, np.ndarray]:
    if leaf not in _LEAF_NAMES:
        raise KeyError(f"unknown flax parameter leaf {leaf!r}")
    if leaf == "kernel":
        if value.ndim == 2:        # Dense [in, out]
            value = value.T
        elif value.ndim == 3:      # 1D conv WIO
            value = value.transpose(2, 1, 0)
        elif value.ndim == 4:      # 2D conv HWIO
            value = value.transpose(3, 2, 0, 1)
        else:
            raise ValueError(f"kernel of rank {value.ndim}")
    return _LEAF_NAMES[leaf], value


def to_state_dict(params) -> Dict[str, torch.Tensor]:
    out = {}
    for path, value in flatten_params(params).items():
        *mods, leaf = path.split("/")
        name, value = convert_leaf(leaf, value)
        out[".".join([*mods, name])] = torch.tensor(value, dtype=torch.float32)
    return out


def load_flax_params(module: nn.Module, params) -> nn.Module:
    """Copy JAX parameters into ``module`` in place; strict."""
    sd = to_state_dict(params)
    own = module.state_dict()
    missing = sorted(set(own) - set(sd))
    unexpected = sorted(set(sd) - set(own))
    if missing or unexpected:
        raise KeyError(
            f"{type(module).__name__}: missing keys {missing[:8]}{'...' if len(missing) > 8 else ''}, "
            f"unexpected keys {unexpected[:8]}{'...' if len(unexpected) > 8 else ''}"
        )
    for k, v in sd.items():
        if tuple(own[k].shape) != tuple(v.shape):
            raise ValueError(f"{k}: shape {tuple(v.shape)} does not fit {tuple(own[k].shape)}")
    module.load_state_dict(sd, strict=True)
    return module


def to_flax_params(module: nn.Module) -> Dict[str, Any]:
    """The inverse of ``load_flax_params``: {"params": nested numpy tree}."""
    tree: Dict[str, Any] = {}
    for key, value in module.state_dict().items():
        *mods, name = key.split(".")
        owner = module.get_submodule(".".join(mods))
        v = value.detach().float().cpu().numpy()
        if name == "bias":
            leaf = "bias"
        elif isinstance(owner, nn.Embedding):
            leaf = "embedding"
        elif isinstance(owner, (nn.LayerNorm, nn.GroupNorm)):
            leaf = "scale"
        else:
            leaf = "kernel"
            v = {2: lambda a: a.T, 3: lambda a: a.transpose(2, 1, 0),
                 4: lambda a: a.transpose(2, 3, 1, 0)}[v.ndim](v)
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.ascontiguousarray(v)
    return {"params": tree}
