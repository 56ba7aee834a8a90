"""What the drivers share: seeds, the architecture, building the program's
modules around the benchmark's weights, and the gap of two readings."""

from __future__ import annotations

import gc
from typing import Callable, Dict, Optional

import numpy as np
import torch

from gpubench import weights

# the tiny architecture of CPU rehearsals and tests (the repository's ``--small``)
SMALL = {"denoiser": {"width": 32, "num_heads": 2, "ffn_width": 64, "num_layers": 1},
         "surface_vae": [8, 8, 8, 8], "edge_vae": [8, 8, 8]}
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def architecture(config: dict, device: torch.device) -> dict:
    """The configuration's widths on the card; the tiny ones on the CPU."""
    if device.type == "cpu":
        return SMALL
    return {k: config[k] for k in ("denoiser", "surface_vae", "edge_vae")}


def seeds(seed: int, n: int) -> list:
    """``n`` 63-bit seeds derived from the run's seed (any size)."""
    state = np.random.SeedSequence(int(seed) & ((1 << 128) - 1)).generate_state(n, np.uint64)
    return [int(s) >> 1 for s in state]


def build(makers: Dict[str, Callable[[], torch.nn.Module]], seed: int, device):
    """Build each module on the meta device, make its weights from ``seed``
    on ``device`` (``weights.make``) and load them strictly. Returns
    (modules, weights): the same f32 tensors go to the reference."""
    modules = {}
    for name, make in makers.items():
        with torch.device("meta"):
            modules[name] = make()
    gen = torch.Generator(device=device).manual_seed(seed)
    params = weights.make({n: weights.shapes_of(m) for n, m in modules.items()}, gen, device)
    for name, m in modules.items():
        m = m.to_empty(device=device)
        m.load_state_dict(params[name], strict=True)
        modules[name] = m.eval()
    return modules, params


def rel_gap(a: torch.Tensor, b: torch.Tensor, valid: Optional[torch.Tensor] = None) -> float:
    """||a - b|| / ||b|| over the elements where ``valid`` (broadcast over
    trailing dims) holds; inf where the shapes differ."""
    if tuple(a.shape) != tuple(b.shape):
        return float("inf")
    a, b = a.double(), b.double()
    if valid is not None:
        w = valid.to(a.dtype)
        while w.dim() < a.dim():
            w = w[..., None]
        a, b = a * w, b * w
    den = torch.linalg.vector_norm(b)
    return float(torch.linalg.vector_norm(a - b) / den.clamp(min=1e-30))


def worst(*readings: float) -> float:
    """The largest reading; inf where any is not a number, so that a NaN
    can never pass a limit."""
    return float("inf") if any(r != r for r in readings) else max(readings)


def free_cuda() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
