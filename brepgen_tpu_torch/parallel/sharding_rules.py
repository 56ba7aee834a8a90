"""Tensor parallelism of the denoiser transformer over the mesh's ``model`` axis.

Port of ``brepgen_tpu/parallel/sharding_rules.py``, the Megatron pattern
JAX writes as sharding annotations for XLA to partition:

  qkv kernel   [d, 3d]      -> P(None, 'model')   (head-sharded QKV)
  attn proj    [d, d]       -> P('model', None)   (row-parallel; psum)
  ffn fc1      [d, ffn]     -> P(None, 'model')   (column-parallel)
  ffn fc2      [ffn, d]     -> P('model', None)   (row-parallel; psum)
  embeddings / norms / head -> replicated

Here the same split is done by hand on each rank's copy of the module
(``shard_denoiser``): every encoder layer keeps the weights of its heads of
``attn.qkv`` and ``attn.proj`` and its slice of ``fc1``/``fc2``, and the
row-parallel products (``proj``, ``fc2``) sum their partial outputs over the
axis with one all-reduce before their bias. The qkv weight packs its 3d
outputs as ``[q | k | v]``; a contiguous split of it (what ``P(None,
'model')`` reads as) would hand a rank all of q and a part of k, so each
rank takes the q, k and v rows of its own heads. The attention then runs
through the layer's own kernel path (K1 on the card) on ``[B, S, 3d/T]``
with ``H/T`` heads. It is written for the forward (sampling); training
stays data-parallel, as in the JAX package's production setting.
DTensor's ``parallelize_module`` is not used: the kernels take plain
tensors.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn


class RowParallelLinear(nn.Module):
    """``x @ W[:, cols]^T`` summed over the ranks of ``group``, then the bias:
    the product of a full ``nn.Linear`` whose input columns are split."""

    def __init__(self, weight: torch.Tensor, bias: torch.Tensor, group):
        super().__init__()
        self.weight = nn.Parameter(weight.detach().clone())
        self.bias = nn.Parameter(bias.detach().clone())
        self.group = group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x, self.weight)
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=self.group)
        return y + self.bias.to(y.dtype)


def _rows(linear: nn.Linear, rows) -> nn.Linear:
    """A Linear keeping the output rows ``rows`` of ``linear``."""
    out = nn.Linear(linear.in_features, len(rows), device=linear.weight.device,
                    dtype=linear.weight.dtype)
    with torch.no_grad():
        out.weight.copy_(linear.weight[rows])
        out.bias.copy_(linear.bias[rows])
    return out


def head_rows(width: int, num_heads: int, rank: int, parts: int) -> torch.Tensor:
    """The rows of a packed ``[q | k | v]`` qkv weight (3 x ``width`` outputs)
    that belong to heads ``rank * H/T .. (rank + 1) * H/T``: q, k and v of
    those heads, in that order."""
    if num_heads % parts:
        raise ValueError(f"{num_heads} heads do not split over {parts} ranks")
    d = width // num_heads
    per = num_heads // parts
    lo, hi = rank * per * d, (rank + 1) * per * d
    return torch.cat([torch.arange(lo, hi) + j * width for j in range(3)])


def shard_encoder_layer(layer: nn.Module, rank: int, parts: int, group) -> nn.Module:
    """Keep this rank's heads and FFN slice of one ``EncoderLayer`` (in place)."""
    attn = layer.attn
    width = attn.proj.out_features
    if layer.fc1.out_features % parts:
        raise ValueError(f"FFN width {layer.fc1.out_features} does not split over {parts}")
    cols = torch.arange(rank * width // parts, (rank + 1) * width // parts)  # its heads
    attn.qkv = _rows(attn.qkv, head_rows(width, attn.num_heads, rank, parts))
    attn.proj = RowParallelLinear(attn.proj.weight[:, cols], attn.proj.bias, group)
    attn.num_heads //= parts
    f = layer.fc1.out_features // parts
    ffn = torch.arange(rank * f, (rank + 1) * f)
    layer.fc1 = _rows(layer.fc1, ffn)
    layer.fc2 = RowParallelLinear(layer.fc2.weight[:, ffn], layer.fc2.bias, group)
    return layer


def shard_denoiser(model: nn.Module, mesh) -> nn.Module:
    """Split every encoder layer of a ``DenoiserTransformer`` over the mesh's
    ``model`` axis, in place; embedders, norms and head stay replicated.
    The model's weights must be equal on every rank (``mesh.replicate``)."""
    names = mesh.mesh_dim_names
    parts = mesh.size(names.index("model"))
    if parts == 1:
        return model
    rank, group = mesh.get_local_rank("model"), mesh.get_group("model")
    enc = model.encoder
    for i in range(enc.num_layers):
        shard_encoder_layer(getattr(enc, f"layer_{i}"), rank, parts, group)
    return model
