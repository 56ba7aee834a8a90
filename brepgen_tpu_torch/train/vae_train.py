"""The VAE loss and the frozen encode/decode functions the LDM steps use.

Port of ``brepgen_tpu/train/vae_train.py``: loss = MSE(recon, x) + 1e-6 *
mean(KL) with a sampled posterior (reference ``trainer.py:79-86,205-216``);
the frozen fast-encode is the posterior mode (reference ``network.py:944``).
The VAE training CLI waits for a later slice (ROADMAP queue 1).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

KL_WEIGHT = 1e-6


def vae_loss(model: nn.Module, batch: torch.Tensor, generator: Optional[torch.Generator] = None,
             eps: Optional[torch.Tensor] = None):
    """batch: [B, ...] grids (channels-last). Returns (loss, (mse, kl)); the
    posterior draw is ``eps`` when given, else from ``generator``."""
    posterior = model.encode(batch)
    dec = model.decode(posterior.sample(generator, eps))
    mse = torch.mean((dec - batch) ** 2)
    kl = torch.mean(posterior.kl())
    return mse + KL_WEIGHT * kl, (mse, kl)


def make_encoder_fn(model: nn.Module) -> Callable[[torch.Tensor], torch.Tensor]:
    """Frozen fast-encode: the posterior mode, without gradients."""

    @torch.no_grad()
    def encode(batch: torch.Tensor) -> torch.Tensor:
        return model.encode(batch).mode()

    return encode


def make_decoder_fn(model: nn.Module) -> Callable[[torch.Tensor], torch.Tensor]:
    @torch.no_grad()
    def decode(z: torch.Tensor) -> torch.Tensor:
        return model.decode(z)

    return decode
