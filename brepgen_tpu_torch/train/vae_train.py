"""VAE training steps (surface 2D / edge 1D), the VAE loss, and the frozen
encode/decode functions the LDM steps use.

Port of ``brepgen_tpu/train/vae_train.py``: loss = MSE(recon, x) + 1e-6 *
mean(KL) with a sampled posterior (reference ``trainer.py:79-86,205-216``);
the frozen fast-encode is the posterior mode (reference ``network.py:944``).
Torch cannot replay JAX's PRNG, so every posterior draw is injectable
(``eps``, the shape of the latent) or comes from a ``torch.Generator``.
``compute_dtype=torch.bfloat16`` runs the VAE under ``torch.autocast`` over
f32 parameters (the JAX ``--bf16``); the moments, the reconstruction and the
losses are f32.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn

from brepgen_tpu_torch.train.common import TrainState
from brepgen_tpu_torch.train.ldm_train import autocast

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


def make_train_step(model: nn.Module, compute_dtype: Optional[torch.dtype] = None) -> Callable:
    """fn(state, batch, generator=None, eps=None) -> {"loss", "mse", "kl"}:
    the loss, its backward and one step of ``state.optimizer`` (the VAE
    optimizer: global-norm clip 5.0, AdamW lr 5e-4, wd 1e-5)."""

    def step(state: TrainState, batch: torch.Tensor, generator: Optional[torch.Generator] = None,
             eps: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        with autocast(batch.device, compute_dtype):
            loss, (mse, kl) = vae_loss(model, batch, generator, eps)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return {"loss": loss.detach(), "mse": mse.detach(), "kl": kl.detach()}

    return step


def make_eval_step(model: nn.Module, compute_dtype: Optional[torch.dtype] = None) -> Callable:
    """fn(batch, generator=None, eps=None) -> the sum over the batch of each
    item's mean squared reconstruction error, through a sampled posterior
    (the reference validates with a sampled z too)."""

    @torch.no_grad()
    def evaluate(batch: torch.Tensor, generator: Optional[torch.Generator] = None,
                 eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        with autocast(batch.device, compute_dtype):
            dec = model.decode(model.encode(batch).sample(generator, eps))
        return torch.sum(torch.mean((dec - batch) ** 2, dim=tuple(range(1, batch.dim()))))

    return evaluate


def make_encoder_fn(model: nn.Module, compute_dtype: Optional[torch.dtype] = None
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Frozen fast-encode: the posterior mode, without gradients, in
    ``compute_dtype`` (autocast, or f32 for None) whatever the caller's
    thread has set: autocast is thread-local, and the latent cache encodes
    in the batch producer's thread."""

    def encode(batch: torch.Tensor) -> torch.Tensor:
        with torch.no_grad(), torch.autocast(batch.device.type, enabled=False), \
                autocast(batch.device, compute_dtype):
            return model.encode(batch).mode()

    return encode


def make_decoder_fn(model: nn.Module) -> Callable[[torch.Tensor], torch.Tensor]:
    @torch.no_grad()
    def decode(z: torch.Tensor) -> torch.Tensor:
        return model.decode(z)

    return decode
