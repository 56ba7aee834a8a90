"""Pre-LN transformer encoder over padded token sets.

Port of ``brepgen_tpu/nn/transformer.py``: pre-LN, ReLU FFN, a final
LayerNorm, the fused ``qkv`` Dense, a key-padding mask (True = pad) and no
positional encoding. Dropout (0.1) follows the attention, the ReLU and fc2
while training, as in ``brepgen_tpu/nn/transformer.py:113-121``; its masks
come from an explicit ``torch.Generator``. Attention runs through the CUDA
kernels (``attn_impl="kernel"``, the edge stages) or plain torch ops
(``"plain"``, the short surf stages), as the JAX package routes the edge
stages to Pallas and the surf stages to XLA. On the kernel path the set
length picks the kernel by the JAX layer's rule (``attention_route``); every
route is differentiable (K1's backward is kernel K5).

``remat`` True or "full" recomputes each layer in the backward
(``torch.utils.checkpoint``; the recompute launches K1 again). ``"dots"`` is
selective checkpointing, the counterpart of JAX's
``dots_with_no_batch_dims_saveable`` (``brepgen_tpu/nn/transformer.py:
134-150``): the outputs of the dense products (``aten.mm`` / ``addmm``: qkv,
proj, fc1, fc2) are kept, and the rest of the layer, the attention kernel
included, is recomputed; the kernels are autograd functions whose forward
reruns in the recompute, so K1 still launches twice per layer. Each layer's
dropout masks come from a seed drawn before the layer runs, so the recompute
draws the same masks.

Under data parallelism (``row_split``, a ``parallel.distributed.RowSplit``)
each rank holds some rows of a global batch: its masks are drawn at the
global batch's shape and its rows kept, so the ranks' union draws the masks
of the single-process step (the JAX step draws them so under its mesh).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
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


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator,
            row_split=None) -> torch.Tensor:
    """Zero each element with probability ``rate`` and scale the rest by
    1 / (1 - rate), as flax's ``nn.Dropout``; the mask from ``generator``,
    drawn at the global batch's shape and cut to this rank's rows under a
    ``row_split``."""
    if row_split is None:
        keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    else:
        shape = (row_split.global_rows(x.shape[0]), *x.shape[1:])
        keep = row_split.take(torch.rand(shape, generator=generator, device=x.device)) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class EncoderLayer(nn.Module):
    def __init__(self, width: int, num_heads: int, ffn_width: int, attn_impl: str = "plain",
                 dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.norm1 = LayerNorm(width)
        self.attn = MultiHeadSelfAttention(width, num_heads, attn_impl)
        self.norm2 = LayerNorm(width)
        self.fc1 = nn.Linear(width, ffn_width)
        self.fc2 = nn.Linear(ffn_width, width)

    def forward(self, x, key_padding_mask=None, seed: Optional[int] = None, row_split=None):
        """``seed`` (training) seeds this layer's dropout masks; None runs
        without dropout. ``row_split``: see ``dropout``."""
        if seed is None or self.dropout == 0.0:
            drop = lambda h: h  # noqa: E731
        else:
            gen = torch.Generator(device=x.device)
            gen.manual_seed(seed)
            drop = lambda h: dropout(h, self.dropout, gen, row_split)  # noqa: E731
        x = x + drop(self.attn(self.norm1(x), key_padding_mask))
        return x + drop(self.fc2(drop(F.relu(self.fc1(self.norm2(x))))))


REMATS = (False, True, "full", "dots")
# the dense products whose outputs "dots" keeps: dot_generals with no batch
# dims in JAX; the attention's batched products (bmm) are recomputed
DOTS_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def dots_policy(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat="dots"``: keep the dense
    products, recompute everything else (fresh outputs of the kernels'
    ``torch.empty`` included, so their forward runs again)."""
    if op in DOTS_SAVED:
        return torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE
    return torch.utils.checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


class TransformerEncoder(nn.Module):
    def __init__(self, width: int = 768, num_heads: int = 12, ffn_width: int = 1024,
                 num_layers: int = 12, attn_impl: str = "plain", dropout: float = 0.1,
                 remat=False):
        super().__init__()
        if remat not in REMATS:
            raise ValueError(f"remat must be one of {REMATS}, got {remat!r}")
        self.num_layers = num_layers
        self.dropout = dropout
        self.remat = "dots" if remat == "dots" else bool(remat)
        self.row_split = None  # this rank's rows of the batch (data-parallel training)
        for i in range(num_layers):  # attribute names are the flax scopes
            setattr(self, f"layer_{i}",
                    EncoderLayer(width, num_heads, ffn_width, attn_impl, dropout))
        self.final_norm = LayerNorm(width)

    def forward(self, x: torch.Tensor, key_padding_mask: Optional[torch.Tensor] = None,
                train: bool = False, generator: Optional[torch.Generator] = None):
        """``train`` turns dropout on, with one seed per layer drawn from
        ``generator``; with ``remat`` and grad enabled each layer is
        recomputed in the backward."""
        drop = train and self.dropout > 0.0
        if drop and generator is None:
            raise ValueError("train=True needs a generator for the dropout masks")
        for i in range(self.num_layers):
            layer = getattr(self, f"layer_{i}")
            seed = None
            if drop:
                seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
            if self.remat and torch.is_grad_enabled():
                kw = {}
                if self.remat == "dots":
                    kw["context_fn"] = functools.partial(
                        torch.utils.checkpoint.create_selective_checkpoint_contexts, dots_policy)
                x = torch.utils.checkpoint.checkpoint(layer, x, key_padding_mask, seed,
                                                      self.row_split, use_reentrant=False, **kw)
            else:
                x = layer(x, key_padding_mask, seed, self.row_split)
        return self.final_norm(x)
