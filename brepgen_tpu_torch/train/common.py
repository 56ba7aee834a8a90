"""Shared training machinery: state, optimizers, losses.

Port of ``brepgen_tpu/train/common.py``. The optimizer settings are the
reference's (``common.py:27-40``):
  * VAEs: AdamW lr 5e-4, wd 1e-5, clip 5.0;
  * LDMs: AdamW lr 5e-4, betas (0.95, 0.999), eps 1e-8, wd 1e-6, clip 50.0;
each as ``optax.chain(clip_by_global_norm(clip), adamw(...))``. The clip is
written by hand to match optax: the gradients are scaled by ``clip / norm``
(divided by the norm, then multiplied by the clip) only when ``norm >= clip``,
with no ``+1e-6`` as ``torch.nn.utils.clip_grad_norm_`` adds. torch's AdamW
decays by ``lr * wd * param`` and scales the bias-corrected moments as
optax's ``adamw`` does (up to rounding); a parameter without a gradient gets
a zero gradient, so it decays as in optax.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable

import torch
from torch import nn

from brepgen_tpu_torch.parallel.distributed import all_reduce_sum


class ClippedAdamW:
    """Global-norm clip, then AdamW, over ``params``."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 1e-4, clip: float = 1.0):
        self.params = [p for p in params if p.requires_grad]
        self.clip = clip
        self.adamw = torch.optim.AdamW(self.params, lr=lr, betas=betas, eps=eps,
                                       weight_decay=weight_decay)

    def global_norm(self) -> torch.Tensor:
        """sqrt of the sum of squares of every gradient (optax.global_norm)."""
        return torch.sqrt(sum(torch.sum(p.grad.float() ** 2) for p in self.params))

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """Clip the gradients in place, take one AdamW step, clear the
        gradients; returns the norm before clipping."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        norm = self.global_norm()
        keep = norm < self.clip
        for p in self.params:
            p.grad.copy_(torch.where(keep, p.grad, p.grad / norm * self.clip))
        self.adamw.step()
        self.adamw.zero_grad(set_to_none=True)
        return norm

    def state_dict(self):
        return self.adamw.state_dict()

    def load_state_dict(self, state):
        self.adamw.load_state_dict(state)


def make_vae_optimizer(params, lr: float = 5e-4, weight_decay: float = 1e-5,
                       clip: float = 5.0) -> ClippedAdamW:
    return ClippedAdamW(params, lr, weight_decay=weight_decay, clip=clip)


def make_ldm_optimizer(params, lr: float = 5e-4, weight_decay: float = 1e-6,
                       clip: float = 50.0) -> ClippedAdamW:
    return ClippedAdamW(params, lr, betas=(0.95, 0.999), eps=1e-8,
                        weight_decay=weight_decay, clip=clip)


@dataclass
class TrainState:
    """The module being trained, its optimizer and the count of steps taken."""

    module: nn.Module
    optimizer: ClippedAdamW
    step: int = 0


def masked_mse(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
               row_split=None) -> torch.Tensor:
    """Mean squared error over the elements of unmasked tokens; ``mask`` is
    True at padding, broadcast over trailing feature dims.

    Under data parallelism (``row_split``, this rank's rows of the batch)
    the mean is the global batch's: the count of unmasked elements is
    summed over the ranks (no gradient flows through it) and the rank's sum
    of squares is divided by it and multiplied by the world size, so that
    DistributedDataParallel's average of the ranks' gradients is the
    gradient of the global mean. Ranks hold different counts of valid
    tokens, so the average of per-rank means would not be. The value is
    this rank's share times the world size: ``global_mean`` turns it into
    the global mean for logging."""
    w = (~mask).float()
    while w.dim() < pred.dim():
        w = w[..., None]
    se = (pred - target) ** 2 * w
    count = (w * torch.ones_like(pred)).sum()
    if row_split is None:
        return se.sum() / torch.clamp(count, min=1.0)
    count = all_reduce_sum(count.detach())
    return se.sum() / torch.clamp(count, min=1.0) * row_split.world


def global_mean(loss: torch.Tensor, row_split=None) -> torch.Tensor:
    """The logged value of a rank's loss: under data parallelism the mean
    over the ranks of what each rank's loss is (a global mean for
    ``masked_mse``'s scaled shares, and for per-rank means of equal shares)."""
    loss = loss.detach()
    if row_split is None:
        return loss
    return all_reduce_sum(loss.clone()) / row_split.world
