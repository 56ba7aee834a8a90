"""BrepGen's denoiser (``network.py``): per-stream MLP embedders summed with a
sinusoidal time embedding, a pre-LN transformer encoder (fused qkv, ReLU
FFN, key-padding mask, final LayerNorm) and an MLP head.

``p`` maps parameter names to float32 tensors, as the benchmark made them.
LayerNorm eps is 1e-6 (flax's default, which the published weights were
trained under in this repository's lineage); masked keys take a bias of
-1e9. In training, ``drop`` = (per-layer seeds, rate) replays dropout's
masks: each layer seeds a generator on the tokens' device with its seed and
draws U(0, 1) masks for the attention output, the FFN's hidden units and the
FFN output, in that order, keeping an element where its draw is >= rate.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from gpubench.reference.precision import einsum, linear

STREAMS = {
    "surfpos": ("surfpos",),
    "surfz": ("surfz", "surfpos"),
    "edgepos": ("edgepos", "surfpos", "surfz"),
    "edgez": ("edgez", "vertpos", "edgepos", "surfpos", "surfz"),
}
STREAM_DIMS = {"surfpos": 6, "surfz": 48, "edgepos": 6, "edgez": 12, "vertpos": 6}
OUT_DIMS = {"surfpos": 6, "surfz": 48, "edgepos": 6, "edgez": 18}
LN_EPS = 1e-6
NEG_INF = -1e9
ATTN_CHUNK_BYTES = 4 << 30  # logits of one chunk of batch rows


def layer_norm(x, p, name, eps=LN_EPS):
    return F.layer_norm(x.float(), (x.shape[-1],), p[f"{name}.weight"].float(),
                        p[f"{name}.bias"].float(), eps)


def dense(x, p, name, prec):
    return linear(x, p[f"{name}.weight"], p[f"{name}.bias"], prec)


def mlp_embed(x, p, name, prec):
    """Linear -> LayerNorm -> SiLU -> Linear."""
    h = layer_norm(dense(x, p, f"{name}.fc1", prec), p, f"{name}.norm")
    return dense(F.silu(h), p, f"{name}.fc2", prec)


def sincos(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """[B] -> [B, dim], cos in the first half."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def attention(qkv: torch.Tensor, heads: int, pad: Optional[torch.Tensor], prec: str):
    """[B, S, 3W] -> [B, S, W]; softmax in f32; rows in chunks that bound
    the logits' memory."""
    B, S, W3 = qkv.shape
    W = W3 // 3
    D = W // heads
    rows = max(1, ATTN_CHUNK_BYTES // (heads * S * S * 4))
    out = []
    for b0 in range(0, B, rows):
        q, k, v = (a.reshape(-1, S, heads, D).transpose(1, 2)
                   for a in qkv[b0:b0 + rows].split(W, dim=-1))
        logits = einsum("bhqd,bhkd->bhqk", q, k, prec) * (1.0 / math.sqrt(D))
        if pad is not None:
            logits = logits + torch.where(pad[b0:b0 + rows, None, None, :], NEG_INF, 0.0)
        probs = torch.softmax(logits, dim=-1)
        del logits
        o = einsum("bhqk,bhkd->bhqd", probs, v, prec)
        out.append(o.transpose(1, 2).reshape(-1, S, W))
    return torch.cat(out)


def _dropout(x, rate, gen):
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), device=x.device))


def encoder_layer(x, p, i: int, heads: int, pad, prec, seed: Optional[int] = None,
                  rate: float = 0.0):
    """Layer ``i``; with ``seed`` its dropout masks are drawn from a
    generator on the tokens' device seeded by it."""
    n = f"encoder.layer_{i}"
    gen = None
    if seed is not None and rate:
        gen = torch.Generator(device=x.device)
        gen.manual_seed(int(seed))
    d = (lambda h: h) if gen is None else (lambda h: _dropout(h, rate, gen))
    a = attention(dense(layer_norm(x, p, f"{n}.norm1"), p, f"{n}.attn.qkv", prec), heads, pad,
                  prec)
    x = x + d(dense(a, p, f"{n}.attn.proj", prec))
    h = d(F.relu(dense(layer_norm(x, p, f"{n}.norm2"), p, f"{n}.fc1", prec)))
    return x + d(dense(h, p, f"{n}.fc2", prec))


def encoder(x, p, heads: int, layers: int, pad, prec,
            drop: Optional[Tuple[Sequence[int], float]] = None):
    for i in range(layers):
        x = encoder_layer(x, p, i, heads, pad, prec, *((drop[0][i], drop[1]) if drop else ()))
    return layer_norm(x, p, "encoder.final_norm")


def denoise(p: Dict[str, torch.Tensor], stage: str, streams: Dict[str, torch.Tensor], t,
            pad: Optional[torch.Tensor], heads: int, layers: int, prec: str = "f32",
            drop=None) -> torch.Tensor:
    """eps [B, S, out] of stage ``stage``'s denoiser on the named streams
    ([B, S, dim] each) at timestep(s) ``t``; ``pad`` [B, S] is True at
    padding."""
    names = STREAMS[stage]
    if set(streams) != set(names):
        raise ValueError(f"{stage}: streams {sorted(streams)}, expected {sorted(names)}")
    tokens = 0.0
    for name in names:
        s = streams[name]
        if s.shape[-1] != STREAM_DIMS[name]:
            raise ValueError(f"stream {name}: {tuple(s.shape)}")
        tokens = tokens + mlp_embed(s, p, f"{name}_embed", prec)
    B = tokens.shape[0]
    width = p["time_embed.fc1.weight"].shape[1]
    t = torch.as_tensor(t, device=tokens.device).reshape(-1).expand(B)
    tokens = tokens + mlp_embed(sincos(t, width), p, "time_embed", prec)[:, None, :]
    out = encoder(tokens, p, heads, layers, pad, prec, drop)
    return mlp_embed(out, p, "head", prec)
