"""Surface VAE: 2D convolutional KL-autoencoder over 32x32x3 UV grids.

Port of ``brepgen_tpu/nn/vae2d.py``. The public ``encode``/``decode`` keep the
JAX package's channels-last layout ([N, 32, 32, 3] <-> [N, 4, 4, 3]); inside,
tensors are channels-first as torch's convolutions want them. GroupNorm
(eps 1e-6) runs in f32; upsampling is nearest x2 then a 3x3 conv.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from brepgen_tpu_torch.nn.layers import DiagonalGaussian, GroupNorm


def _groups(channels: int, target: int = 32) -> int:
    """Largest divisor of ``channels`` not exceeding ``target``."""
    g = min(target, channels)
    while channels % g:
        g -= 1
    return g


def group_norm(channels: int, eps: float = 1e-6) -> GroupNorm:
    return GroupNorm(_groups(channels), channels, eps=eps)


def _conv3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1)


def _add_block(parent: nn.Module, name: str, block: nn.Module) -> None:
    """Register ``block`` under its flax scope name, in call order."""
    parent.add_module(name, block)
    parent.names.append(name)


class ResnetBlock2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.norm1 = group_norm(in_channels)
        self.conv1 = _conv3(in_channels, out_channels)
        self.norm2 = group_norm(out_channels)
        self.conv2 = _conv3(out_channels, out_channels)
        if in_channels != out_channels:
            self.conv_shortcut = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x):
        dt = x.dtype
        h = self.conv1(F.silu(self.norm1(x)).to(dt))
        h = self.conv2(F.silu(self.norm2(h)).to(dt))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class AttnBlock2D(nn.Module):
    """Single-head spatial self-attention (VAE mid-block style)."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = group_norm(channels)
        self.q = nn.Linear(channels, channels)
        self.k = nn.Linear(channels, channels)
        self.v = nn.Linear(channels, channels)
        self.proj = nn.Linear(channels, channels)

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.norm(x).to(x.dtype).reshape(B, C, H * W).transpose(1, 2)
        q, k, v = self.q(h), self.k(h), self.v(h)
        scale = 1.0 / float(C) ** 0.5
        attn = torch.softmax((torch.einsum("bqc,bkc->bqk", q, k) * scale).float(), dim=-1)
        h = self.proj(torch.einsum("bqk,bkc->bqc", attn.to(x.dtype), v))
        return x + h.transpose(1, 2).reshape(B, C, H, W)


class Downsample2D(nn.Module):
    """Stride-2 conv with diffusers' asymmetric (0,1,0,1) padding."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample2D(nn.Module):
    """Nearest-neighbour x2 + 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = _conv3(channels, channels)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class MidBlock2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.res1 = ResnetBlock2D(channels, channels)
        self.attn = AttnBlock2D(channels)
        self.res2 = ResnetBlock2D(channels, channels)

    def forward(self, x):
        return self.res2(self.attn(self.res1(x)))


class Encoder2D(nn.Module):
    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 512, 512),
                 layers_per_block: int = 2, latent_channels: int = 3):
        super().__init__()
        ch = list(block_out_channels)
        self.names = []
        self.conv_in = _conv3(3, ch[0])
        cin = ch[0]
        for i, c in enumerate(ch):
            for j in range(layers_per_block):
                _add_block(self, f"down{i}_res{j}", ResnetBlock2D(cin, c))
                cin = c
            if i < len(ch) - 1:
                _add_block(self, f"down{i}_downsample", Downsample2D(c))
        self.mid = MidBlock2D(ch[-1])
        self.norm_out = group_norm(ch[-1])
        self.conv_out = _conv3(ch[-1], 2 * latent_channels)

    def forward(self, x):
        x = self.conv_in(x)
        for name in self.names:
            x = getattr(self, name)(x)
        x = self.mid(x)
        return self.conv_out(F.silu(self.norm_out(x)).to(x.dtype))


class Decoder2D(nn.Module):
    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 512, 512),
                 layers_per_block: int = 2, out_channels: int = 3, latent_channels: int = 3):
        super().__init__()
        ch = list(reversed(block_out_channels))  # [512, 512, 256, 128]
        self.names = []
        self.conv_in = _conv3(latent_channels, ch[0])
        self.mid = MidBlock2D(ch[0])
        cin = ch[0]
        for i, c in enumerate(ch):
            for j in range(layers_per_block + 1):
                _add_block(self, f"up{i}_res{j}", ResnetBlock2D(cin, c))
                cin = c
            if i < len(ch) - 1:
                _add_block(self, f"up{i}_upsample", Upsample2D(c))
        self.norm_out = group_norm(ch[-1])
        self.conv_out = _conv3(ch[-1], out_channels)

    def forward(self, z):
        x = self.mid(self.conv_in(z))
        for name in self.names:
            x = getattr(self, name)(x)
        return self.conv_out(F.silu(self.norm_out(x)).to(x.dtype))


class SurfVAE(nn.Module):
    """KL-VAE over surface UV grids; latent [N, 4, 4, 3] (channels-last)."""

    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 512, 512),
                 layers_per_block: int = 2, latent_channels: int = 3):
        super().__init__()
        self.encoder = Encoder2D(block_out_channels, layers_per_block, latent_channels)
        self.decoder = Decoder2D(block_out_channels, layers_per_block, 3, latent_channels)
        self.quant_conv = nn.Conv2d(2 * latent_channels, 2 * latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(latent_channels, latent_channels, 1)

    @property
    def dtype(self) -> torch.dtype:
        return self.post_quant_conv.weight.dtype

    def encode_moments(self, x: torch.Tensor) -> torch.Tensor:
        """[N, 32, 32, 3] -> posterior moments (mean, logvar) [N, 4, 4, 6], f32."""
        h = self.quant_conv(self.encoder(x.to(self.dtype).permute(0, 3, 1, 2)))
        return h.permute(0, 2, 3, 1).float()

    def encode(self, x: torch.Tensor) -> DiagonalGaussian:
        """[N, 32, 32, 3] -> the posterior over the latent."""
        return DiagonalGaussian(self.encode_moments(x))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """[N, 4, 4, 3] -> [N, 32, 32, 3], f32."""
        x = self.decoder(self.post_quant_conv(z.to(self.dtype).permute(0, 3, 1, 2)))
        return x.permute(0, 2, 3, 1).float()
