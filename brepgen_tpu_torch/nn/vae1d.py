"""Edge VAE: 1D convolutional KL-autoencoder over 32x3 curve point grids.

Port of ``brepgen_tpu/nn/vae1d.py``. The public ``encode``/``decode`` keep the
JAX package's channels-last layout ([N, 32, 3] <-> [N, 4, 3]); inside, tensors
are [N, C, L]. ResConv blocks use GroupNorm(1) with eps 1e-5 and exact GELU;
the self-attention's GroupNorm(1) also has eps 1e-5; the outer GroupNorm has
eps 1e-6. Resampling is the fixed cubic FIR with reflect padding.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from brepgen_tpu_torch.nn.layers import DiagonalGaussian, GroupNorm
from brepgen_tpu_torch.nn.vae2d import group_norm

# Bicubic antialiasing FIR taps (k-diffusion / diffusers "cubic" kernel).
CUBIC_KERNEL = np.array(
    [-0.01171875, -0.03515625, 0.11328125, 0.43359375,
     0.43359375, 0.11328125, -0.03515625, -0.01171875],
    dtype=np.float32,
)


def _fir_weight(x: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """Depthwise [C, 1, K] filter for x [N, C, L]."""
    w = torch.as_tensor(taps, dtype=x.dtype, device=x.device)
    return w.reshape(1, 1, -1).expand(x.shape[1], 1, -1).contiguous()


def fir_downsample_1d(x: torch.Tensor, taps: np.ndarray = CUBIC_KERNEL) -> torch.Tensor:
    """[N, C, L] -> [N, C, L//2]: reflect-pad then stride-2 depthwise FIR."""
    pad = len(taps) // 2 - 1
    x = F.pad(x, (pad, pad), mode="reflect")
    return F.conv1d(x, _fir_weight(x, taps), stride=2, groups=x.shape[1])


def fir_upsample_1d(x: torch.Tensor, taps: np.ndarray = CUBIC_KERNEL) -> torch.Tensor:
    """[N, C, L] -> [N, C, 2L]: reflect-pad, zero-stuff x2 and filter with the
    doubled taps (a transposed conv), cropped to exactly 2L."""
    K = len(taps)
    p = (K // 2 - 1 + 1) // 2
    L = x.shape[-1]
    x = F.pad(x, (p, p), mode="reflect")
    out = F.conv_transpose1d(x, _fir_weight(x, 2.0 * taps), stride=2, groups=x.shape[1])
    start = (out.shape[-1] - 2 * L) // 2
    return out[..., start:start + 2 * L]


def _gelu_f32(h: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.gelu(h, approximate="none").to(dtype)


class ResConvBlock1D(nn.Module):
    def __init__(self, in_channels: int, mid_channels: int, out_channels: int):
        super().__init__()
        if in_channels != out_channels:
            self.conv_skip = nn.Conv1d(in_channels, out_channels, 1, bias=False)
        self.conv1 = nn.Conv1d(in_channels, mid_channels, 5, padding=2)
        self.norm1 = GroupNorm(1, mid_channels, eps=1e-5)
        self.conv2 = nn.Conv1d(mid_channels, out_channels, 5, padding=2)
        self.norm2 = GroupNorm(1, out_channels, eps=1e-5)

    def forward(self, x):
        dt = x.dtype
        residual = self.conv_skip(x) if hasattr(self, "conv_skip") else x
        h = _gelu_f32(self.norm1(self.conv1(x)), dt)
        h = _gelu_f32(self.norm2(self.conv2(h)), dt)
        return h + residual


class SelfAttention1D(nn.Module):
    def __init__(self, channels: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.norm = GroupNorm(1, channels, eps=1e-5)
        self.q = nn.Linear(channels, channels)
        self.k = nn.Linear(channels, channels)
        self.v = nn.Linear(channels, channels)
        self.proj = nn.Linear(channels, channels)

    def forward(self, x):
        N, C, L = x.shape
        H, D = self.num_heads, C // self.num_heads
        h = self.norm(x).to(x.dtype).transpose(1, 2)  # [N, L, C]
        split = lambda a: a.reshape(N, L, H, D).transpose(1, 2)
        q, k, v = split(self.q(h)), split(self.k(h)), split(self.v(h))
        scale = 1.0 / float(D) ** 0.5
        attn = torch.softmax((torch.einsum("bhqd,bhkd->bhqk", q, k) * scale).float(), dim=-1)
        h = torch.einsum("bhqk,bhkd->bhqd", attn.to(x.dtype), v).transpose(1, 2).reshape(N, L, C)
        return x + self.proj(h).transpose(1, 2)


class MidBlock1D(nn.Module):
    """6x (ResConv -> SelfAttention)."""

    def __init__(self, channels: int):
        super().__init__()
        heads = max(1, channels // 32)
        for i in range(6):
            setattr(self, f"res{i}", ResConvBlock1D(channels, channels, channels))
            setattr(self, f"attn{i}", SelfAttention1D(channels, heads))

    def forward(self, x):
        for i in range(6):
            x = getattr(self, f"attn{i}")(getattr(self, f"res{i}")(x))
        return x


class DownBlock1D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        c = out_channels
        self.res0 = ResConvBlock1D(in_channels, c, c)
        self.res1 = ResConvBlock1D(c, c, c)
        self.res2 = ResConvBlock1D(c, c, c)

    def forward(self, x):
        return self.res2(self.res1(self.res0(fir_downsample_1d(x))))


class UpBlock1D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        c = in_channels
        self.res0 = ResConvBlock1D(c, c, c)
        self.res1 = ResConvBlock1D(c, c, c)
        self.res2 = ResConvBlock1D(c, c, out_channels)

    def forward(self, x):
        return fir_upsample_1d(self.res2(self.res1(self.res0(x))))


class Encoder1D(nn.Module):
    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 512),
                 latent_channels: int = 3):
        super().__init__()
        ch = list(block_out_channels)
        self.num_blocks = len(ch)
        self.conv_in = nn.Conv1d(3, ch[0], 3, padding=1)
        cin = ch[0]
        for i, c in enumerate(ch):
            setattr(self, f"down{i}", DownBlock1D(cin, c))
            cin = c
        self.mid = MidBlock1D(ch[-1])
        self.norm_out = group_norm(ch[-1])
        self.conv_out = nn.Conv1d(ch[-1], 2 * latent_channels, 3, padding=1)

    def forward(self, x):
        x = self.conv_in(x)
        for i in range(self.num_blocks):
            x = getattr(self, f"down{i}")(x)
        x = self.mid(x)
        return self.conv_out(F.silu(self.norm_out(x)).to(x.dtype))


class Decoder1D(nn.Module):
    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 512),
                 out_channels: int = 3, latent_channels: int = 3):
        super().__init__()
        ch = list(reversed(block_out_channels))  # [512, 256, 128]
        self.num_blocks = len(ch)
        self.conv_in = nn.Conv1d(latent_channels, ch[0], 3, padding=1)
        self.mid = MidBlock1D(ch[0])
        cin = ch[0]
        for i, c in enumerate(ch):
            setattr(self, f"up{i}", UpBlock1D(cin, c))
            cin = c
        self.norm_out = group_norm(ch[-1])
        self.conv_out = nn.Conv1d(ch[-1], out_channels, 3, padding=1)

    def forward(self, z):
        x = self.mid(self.conv_in(z))
        for i in range(self.num_blocks):
            x = getattr(self, f"up{i}")(x)
        return self.conv_out(F.silu(self.norm_out(x)).to(x.dtype))


class EdgeVAE(nn.Module):
    """KL-VAE over edge u-grids; [N, 32, 3] <-> latent [N, 4, 3] (channels-last)."""

    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 512),
                 latent_channels: int = 3):
        super().__init__()
        self.encoder = Encoder1D(block_out_channels, latent_channels)
        self.decoder = Decoder1D(block_out_channels, 3, latent_channels)
        self.quant_conv = nn.Conv1d(2 * latent_channels, 2 * latent_channels, 1)
        self.post_quant_conv = nn.Conv1d(latent_channels, latent_channels, 1)

    @property
    def dtype(self) -> torch.dtype:
        return self.post_quant_conv.weight.dtype

    def encode_moments(self, x: torch.Tensor) -> torch.Tensor:
        """[N, 32, 3] -> posterior moments (mean, logvar) [N, 4, 6], f32."""
        h = self.quant_conv(self.encoder(x.to(self.dtype).transpose(1, 2)))
        return h.transpose(1, 2).float()

    def encode(self, x: torch.Tensor) -> DiagonalGaussian:
        """[N, 32, 3] -> the posterior over the latent."""
        return DiagonalGaussian(self.encode_moments(x))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """[N, 4, 3] -> [N, 32, 3], f32."""
        x = self.decoder(self.post_quant_conv(z.to(self.dtype).transpose(1, 2)))
        return x.transpose(1, 2).float()
