"""BrepGen's surface and edge VAEs (diffusers' ``AutoencoderKL`` over 32 x 32
UV grids, and the 1-D ``AutoencoderKL1D`` over 32-point curves), encode to
the posterior mode and decode, channels-last at the boundary as the
repository's latents are laid out: surface [N, 32, 32, 3] <-> [N, 4, 4, 3],
edge [N, 32, 3] <-> [N, 4, 3].

Surface: GroupNorm of min(32, C) groups (the largest divisor of C up to
32), eps 1e-6; SiLU; resnet blocks with a 1 x 1 shortcut where the width
changes; one single-head spatial attention in the middle block; stride-2
downsampling with (0, 1, 0, 1) padding; nearest x2 upsampling then a 3 x 3
conv. Edge: res-conv blocks (kernel 5, GroupNorm(1) eps 1e-5, exact GELU),
six res-conv + multi-head self-attention pairs (heads = C / 32) in the
middle block, cubic FIR resampling with reflect padding, an outer
GroupNorm of eps 1e-6.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from gpubench.reference.precision import conv1d, conv2d, einsum, linear

CUBIC = np.array([-0.01171875, -0.03515625, 0.11328125, 0.43359375,
                  0.43359375, 0.11328125, -0.03515625, -0.01171875], dtype=np.float32)


def _groups(c: int, target: int = 32) -> int:
    g = min(target, c)
    while c % g:
        g -= 1
    return g


def gn(x, p, name, groups, eps):
    return F.group_norm(x.float(), groups, p[f"{name}.weight"].float(),
                        p[f"{name}.bias"].float(), eps)


def dense(x, p, name, prec):
    return linear(x, p[f"{name}.weight"], p.get(f"{name}.bias"), prec)


# --- surface (2-D) -----------------------------------------------------------

def _c2(x, p, name, prec, **kw):
    return conv2d(x, p[f"{name}.weight"], p.get(f"{name}.bias"), prec, **kw)


def _res2(x, p, n, prec):
    cin, cout = x.shape[1], p[f"{n}.conv1.weight"].shape[0]
    h = _c2(F.silu(gn(x, p, f"{n}.norm1", _groups(cin), 1e-6)), p, f"{n}.conv1", prec, padding=1)
    h = _c2(F.silu(gn(h, p, f"{n}.norm2", _groups(cout), 1e-6)), p, f"{n}.conv2", prec,
            padding=1)
    if f"{n}.conv_shortcut.weight" in p:
        x = _c2(x, p, f"{n}.conv_shortcut", prec)
    return x + h


def _attn2(x, p, n, prec):
    B, C, H, W = x.shape
    h = gn(x, p, f"{n}.norm", _groups(C), 1e-6).reshape(B, C, H * W).transpose(1, 2)
    q, k, v = (dense(h, p, f"{n}.{s}", prec) for s in "qkv")
    attn = torch.softmax(einsum("bqc,bkc->bqk", q, k, prec) / C ** 0.5, dim=-1)
    h = dense(einsum("bqk,bkc->bqc", attn, v, prec), p, f"{n}.proj", prec)
    return x + h.transpose(1, 2).reshape(B, C, H, W)


def _mid2(x, p, n, prec):
    return _res2(_attn2(_res2(x, p, f"{n}.res1", prec), p, f"{n}.attn", prec),
                 p, f"{n}.res2", prec)


def surf_encode(p: Dict[str, torch.Tensor], grids: torch.Tensor, channels: Sequence[int],
                prec: str = "f32", layers_per_block: int = 2) -> torch.Tensor:
    """[N, 32, 32, 3] -> posterior mode [N, 4, 4, 3]."""
    x = _c2(grids.float().permute(0, 3, 1, 2), p, "encoder.conv_in", prec, padding=1)
    for i, _ in enumerate(channels):
        for j in range(layers_per_block):
            x = _res2(x, p, f"encoder.down{i}_res{j}", prec)
        if i < len(channels) - 1:
            x = _c2(F.pad(x, (0, 1, 0, 1)), p, f"encoder.down{i}_downsample.conv", prec,
                    stride=2)
    x = _mid2(x, p, "encoder.mid", prec)
    x = _c2(F.silu(gn(x, p, "encoder.norm_out", _groups(channels[-1]), 1e-6)),
            p, "encoder.conv_out", prec, padding=1)
    moments = _c2(x, p, "quant_conv", prec)
    return moments[:, :moments.shape[1] // 2].permute(0, 2, 3, 1)


def surf_decode(p: Dict[str, torch.Tensor], z: torch.Tensor, channels: Sequence[int],
                prec: str = "f32", layers_per_block: int = 2) -> torch.Tensor:
    """[N, 4, 4, 3] -> [N, 32, 32, 3]."""
    ch = list(reversed(channels))
    x = _c2(z.float().permute(0, 3, 1, 2), p, "post_quant_conv", prec)
    x = _mid2(_c2(x, p, "decoder.conv_in", prec, padding=1), p, "decoder.mid", prec)
    for i, _ in enumerate(ch):
        for j in range(layers_per_block + 1):
            x = _res2(x, p, f"decoder.up{i}_res{j}", prec)
        if i < len(ch) - 1:
            x = _c2(F.interpolate(x, scale_factor=2, mode="nearest"), p,
                    f"decoder.up{i}_upsample.conv", prec, padding=1)
    x = _c2(F.silu(gn(x, p, "decoder.norm_out", _groups(ch[-1]), 1e-6)),
            p, "decoder.conv_out", prec, padding=1)
    return x.permute(0, 2, 3, 1)


# --- edge (1-D) ------------------------------------------------------------------

def _c1(x, p, name, prec, **kw):
    return conv1d(x, p[f"{name}.weight"], p.get(f"{name}.bias"), prec, **kw)


def _fir(x, taps):
    w = torch.as_tensor(taps, dtype=torch.float32, device=x.device)
    return w.reshape(1, 1, -1).expand(x.shape[1], 1, -1).contiguous()


def _down(x):
    pad = len(CUBIC) // 2 - 1
    x = F.pad(x, (pad, pad), mode="reflect")
    return F.conv1d(x, _fir(x, CUBIC), stride=2, groups=x.shape[1])


def _up(x):
    p = len(CUBIC) // 4
    L = x.shape[-1]
    x = F.pad(x, (p, p), mode="reflect")
    out = F.conv_transpose1d(x, _fir(x, 2.0 * CUBIC), stride=2, groups=x.shape[1])
    start = (out.shape[-1] - 2 * L) // 2
    return out[..., start:start + 2 * L]


def _res1(x, p, n, prec):
    skip = _c1(x, p, f"{n}.conv_skip", prec) if f"{n}.conv_skip.weight" in p else x
    h = F.gelu(gn(_c1(x, p, f"{n}.conv1", prec, padding=2), p, f"{n}.norm1", 1, 1e-5))
    h = F.gelu(gn(_c1(h, p, f"{n}.conv2", prec, padding=2), p, f"{n}.norm2", 1, 1e-5))
    return h + skip


def _attn1(x, p, n, prec):
    N, C, L = x.shape
    H = max(1, C // 32)
    D = C // H
    h = gn(x, p, f"{n}.norm", 1, 1e-5).transpose(1, 2)
    q, k, v = (dense(h, p, f"{n}.{s}", prec).reshape(N, L, H, D).transpose(1, 2)
               for s in "qkv")
    attn = torch.softmax(einsum("bhqd,bhkd->bhqk", q, k, prec) / D ** 0.5, dim=-1)
    h = einsum("bhqk,bhkd->bhqd", attn, v, prec).transpose(1, 2).reshape(N, L, C)
    return x + dense(h, p, f"{n}.proj", prec).transpose(1, 2)


def _mid1(x, p, n, prec):
    for i in range(6):
        x = _attn1(_res1(x, p, f"{n}.res{i}", prec), p, f"{n}.attn{i}", prec)
    return x


def edge_encode(p: Dict[str, torch.Tensor], curves: torch.Tensor, channels: Sequence[int],
                prec: str = "f32") -> torch.Tensor:
    """[N, 32, 3] -> posterior mode [N, 4, 3]."""
    x = _c1(curves.float().transpose(1, 2), p, "encoder.conv_in", prec, padding=1)
    for i, _ in enumerate(channels):
        x = _down(x)
        for j in range(3):
            x = _res1(x, p, f"encoder.down{i}.res{j}", prec)
    x = _mid1(x, p, "encoder.mid", prec)
    x = _c1(F.silu(gn(x, p, "encoder.norm_out", _groups(channels[-1]), 1e-6)),
            p, "encoder.conv_out", prec, padding=1)
    moments = _c1(x, p, "quant_conv", prec)
    return moments[:, :moments.shape[1] // 2].transpose(1, 2)


def edge_decode(p: Dict[str, torch.Tensor], z: torch.Tensor, channels: Sequence[int],
                prec: str = "f32") -> torch.Tensor:
    """[N, 4, 3] -> [N, 32, 3]."""
    ch = list(reversed(channels))
    x = _c1(z.float().transpose(1, 2), p, "post_quant_conv", prec)
    x = _mid1(_c1(x, p, "decoder.conv_in", prec, padding=1), p, "decoder.mid", prec)
    for i, _ in enumerate(ch):
        for j in range(3):
            x = _res1(x, p, f"decoder.up{i}.res{j}", prec)
        x = _up(x)
    x = _c1(F.silu(gn(x, p, "decoder.norm_out", _groups(ch[-1]), 1e-6)),
            p, "decoder.conv_out", prec, padding=1)
    return x.transpose(1, 2)


def chunked(fn, x: torch.Tensor, rows: int) -> torch.Tensor:
    """``fn`` over ``x`` in blocks of ``rows``, concatenated."""
    return torch.cat([fn(x[i:i + rows]) for i in range(0, x.shape[0], rows)])
