"""PyTorch and CUDA port of ``brepgen_tpu`` for an NVIDIA H100.

The JAX package beside it is the reference. This package imports torch and
numpy only; where it needs code of the JAX package it keeps its own copy.
Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU, and raise when no card is present. The package itself imports
torch only where it is used, so the host-only CLIs (STEP extraction, one
subprocess per shard) start without it.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

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
