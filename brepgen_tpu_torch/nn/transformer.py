"""Pre-LN transformer encoder over padded token sets.

Port of ``brepgen_tpu/nn/transformer.py``: pre-LN, ReLU FFN, a final
LayerNorm, the fused ``qkv`` Dense, a key-padding mask (True = pad) and no
positional encoding. Inference only: no dropout. Attention runs through the
CUDA kernels (``attn_impl="kernel"``, the edge stages) or plain torch ops
(``"plain"``, the short surf stages), as the JAX package routes the edge
stages to Pallas and the surf stages to XLA. On the kernel path the set
length picks the kernel by the JAX layer's rule (``attention_route``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from brepgen_tpu_torch.kernels import attention as kattn
from brepgen_tpu_torch.kernels.attention import (
    packed_attention,
    packed_attention_reference,
    packed_flash_attention,
)
from brepgen_tpu_torch.kernels.set_attention import set_attention
from brepgen_tpu_torch.nn.layers import LayerNorm

LONG_SET_TOKENS = 8192  # beyond this the JAX layer always takes the packed entry


def attention_route(S: int, W: int, dtype: torch.dtype) -> str:
    """The kernel for a set of ``S`` tokens of width ``W`` in ``dtype``.

    The rule of ``brepgen_tpu/nn/transformer.py:66-88`` and
    ``kernels/attention.py:_needs_kv_streaming``, measured on the full-S K
    (or V) column block in the compute type: ``"packed"`` (K1) while it fits
    ``PACKED_RESIDENT_BYTES``; above that ``"packed_flash"`` (K2) past 8192
    tokens, else ``"per_head"`` (K3).
    """
    kv_bytes = S * W * dtype.itemsize
    if kv_bytes <= kattn.PACKED_RESIDENT_BYTES:
        return "packed"
    return "packed_flash" if S > LONG_SET_TOKENS else "per_head"


def routed_attention(qkv: torch.Tensor, num_heads: int,
                     key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, S, 3W] -> [B, S, W] through the kernel ``attention_route`` picks;
    the per-head route splits the heads into [B, H, S, D] and merges them
    back, as the JAX layer does."""
    B, S, W3 = qkv.shape
    W = W3 // 3
    route = attention_route(S, W, qkv.dtype)
    if route == "packed":
        return packed_attention(qkv, num_heads, key_padding_mask)
    if route == "packed_flash":
        return packed_flash_attention(qkv, num_heads, key_padding_mask)
    D = W // num_heads
    q, k, v = (a.reshape(B, S, num_heads, D).transpose(1, 2).contiguous()
               for a in qkv.split(W, dim=-1))
    out = set_attention(q, k, v, key_padding_mask)
    return out.transpose(1, 2).reshape(B, S, W)


ATTN_IMPLS = {"plain": packed_attention_reference, "kernel": routed_attention}


class MultiHeadSelfAttention(nn.Module):
    def __init__(self, width: int, num_heads: int, attn_impl: str = "plain"):
        super().__init__()
        self.num_heads = num_heads
        self.attn = ATTN_IMPLS[attn_impl]
        self.qkv = nn.Linear(width, 3 * width)
        self.proj = nn.Linear(width, width)

    def forward(self, x, key_padding_mask=None):
        return self.proj(self.attn(self.qkv(x), self.num_heads, key_padding_mask))


class EncoderLayer(nn.Module):
    def __init__(self, width: int, num_heads: int, ffn_width: int, attn_impl: str = "plain"):
        super().__init__()
        self.norm1 = LayerNorm(width)
        self.attn = MultiHeadSelfAttention(width, num_heads, attn_impl)
        self.norm2 = LayerNorm(width)
        self.fc1 = nn.Linear(width, ffn_width)
        self.fc2 = nn.Linear(ffn_width, width)

    def forward(self, x, key_padding_mask=None):
        x = x + self.attn(self.norm1(x), key_padding_mask)
        return x + self.fc2(F.relu(self.fc1(self.norm2(x))))


class TransformerEncoder(nn.Module):
    def __init__(self, width: int = 768, num_heads: int = 12, ffn_width: int = 1024,
                 num_layers: int = 12, attn_impl: str = "plain"):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):  # attribute names are the flax scopes
            setattr(self, f"layer_{i}", EncoderLayer(width, num_heads, ffn_width, attn_impl))
        self.final_norm = LayerNorm(width)

    def forward(self, x: torch.Tensor, key_padding_mask: Optional[torch.Tensor] = None):
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, key_padding_mask)
        return self.final_norm(x)
