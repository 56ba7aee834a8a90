"""PyTorch and CUDA port of ``brepgen_tpu`` for an NVIDIA H100.

The JAX package beside it is the reference. This package imports torch and
numpy only; where it needs code of the JAX package it keeps its own copy.
Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU, and raise when no card is present. The package itself imports
torch only where it is used, so the host-only CLIs (STEP extraction, one
subprocess per shard) start without it.
"""

from __future__ import annotations

import subprocess
from typing import TYPE_CHECKING, Dict

if TYPE_CHECKING:
    import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device to run on; raises for CUDA when no card is present."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def nvidia_smi_card(index: int = 0) -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    return subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def card(device: torch.device) -> Dict[str, object]:
    """The card's name and power limit in watts, or "cpu" and None off the
    card: where a measurement ran."""
    import torch

    if device.type != "cuda":
        return {"device": "cpu", "power_limit_w": None}
    index = torch.cuda.current_device() if device.index is None else device.index
    limit = nvidia_smi_card(index).rsplit(",", 1)[1].split()[0]
    return {"device": torch.cuda.get_device_name(index), "power_limit_w": float(limit)}


def card_line(info: Dict[str, object]) -> str:
    """One line naming where a measurement ran, for the entries' stderr."""
    if info["power_limit_w"] is None:
        return f"device: {info['device']}"
    return f"device: {info['device']}, power limit {info['power_limit_w']:.2f} W"
