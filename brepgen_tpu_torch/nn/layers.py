"""Shared layers: sinusoidal embedding, MLP stream embedder, f32 norms.

Port of ``brepgen_tpu/nn/layers.py``. Norms hold f32 parameters and compute
in f32 whatever the compute type, as flax's norms do; flax's LayerNorm eps is
1e-6 (never set in the JAX package), not torch's 1e-5.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from brepgen_tpu_torch.kernels import add_layer_norm


class LayerNorm(nn.LayerNorm):
    """LayerNorm in f32 with flax's default eps; returns the input's type.

    ``add_forward`` takes the residual add in front of the norm with it; on
    the card without gradients both go through one kernel
    (``kernels/add_layer_norm.py``), elsewhere through the plain ops."""

    def __init__(self, width: int, eps: float = 1e-6):
        super().__init__(width, eps=eps)

    def forward(self, x: torch.Tensor, delta: Optional[torch.Tensor] = None,
                silu: bool = False) -> torch.Tensor:
        """The norm of x + delta (of x without delta), SiLU'd with ``silu``."""
        return self.add_forward(x, delta, silu, keep_sum=False)[1]

    def add_forward(self, x: torch.Tensor, delta: Optional[torch.Tensor] = None,
                    silu: bool = False, keep_sum: bool = True):
        """(s, y): the stream s = x + delta (x without delta) and its norm y,
        SiLU'd with ``silu``; s may be None with ``keep_sum`` False."""
        if add_layer_norm.takes_kernel(x, delta, self.weight, self.bias):
            return add_layer_norm.add_layer_norm(x, delta, self.weight, self.bias, self.eps,
                                                 silu, keep_sum)
        return add_layer_norm.add_layer_norm_reference(x, delta, self.weight, self.bias,
                                                       self.eps, silu)


class GroupNorm(nn.GroupNorm):
    """GroupNorm over channels-first input, computed and returned in f32."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight, self.bias, self.eps)


def sincos_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding, [..., dim] with cos in the first half."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half
    )
    args = t.float()[..., None] * freqs
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[..., :1])], dim=-1)
    return emb


class MLPEmbedder(nn.Module):
    """Linear -> LayerNorm -> SiLU -> Linear: every input stream, the time
    embedding and (with ``out_dim``) the output head."""

    def __init__(self, in_dim: int, width: int, out_dim: Optional[int] = None):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, width)
        self.norm = LayerNorm(width)
        self.fc2 = nn.Linear(width, out_dim if out_dim is not None else width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.norm(self.fc1(x), silu=True))


class DiagonalGaussian:
    """Diagonal Gaussian posterior over channels-last moments [..., 2C] =
    (mean, logvar), logvar clipped to [-30, 20]
    (``brepgen_tpu/nn/layers.py:55-82``)."""

    def __init__(self, moments: torch.Tensor):
        self.mean, logvar = moments.chunk(2, dim=-1)
        self.logvar = logvar.clamp(-30.0, 20.0)
        self.std = torch.exp(0.5 * self.logvar)
        self.var = torch.exp(self.logvar)

    def sample(self, generator: Optional[torch.Generator] = None,
               eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mean + std * eps, eps ~ N(0, 1) from ``generator`` unless given."""
        if eps is None:
            eps = torch.randn(self.mean.shape, generator=generator).to(self.mean.device)
        return self.mean + self.std * eps.to(self.mean.dtype)

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self) -> torch.Tensor:
        """KL(q || N(0, I)) summed over all non-batch dims -> [B]."""
        dims = tuple(range(1, self.mean.dim()))
        return 0.5 * torch.sum(self.mean ** 2 + self.var - 1.0 - self.logvar, dim=dims)


def cast_compute(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Run ``module`` in ``dtype`` (e.g. bf16): dense, conv and embedding
    parameters take the type, norms keep f32 parameters and statistics."""
    module.to(dtype)
    for m in module.modules():
        if isinstance(m, (LayerNorm, GroupNorm)):
            m.float()
    return module
