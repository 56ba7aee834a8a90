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
``attn.qkv`` and ``attn.proj`` and its slice of ``fc1``/``fc2``. The qkv
weight packs its 3d outputs as ``[q | k | v]``; a contiguous split of it
(what ``P(None, 'model')`` reads as) would hand a rank all of q and a part
of k, so each rank takes the q, k and v rows of its own heads. The attention
then runs through the layer's own kernel path (K1 on the card) on
``[B, S, 3d/T]`` with ``H/T`` heads.

The two Megatron operators that XLA inserts for these shardings are written
out as autograd functions, so the split trains as well as it samples:
``f`` (``copy_to_model``: identity forward, the gradient all-reduced over
the ``model`` group backward) on the inputs of the column-parallel ``qkv``
and ``fc1``, and ``g`` (``reduce_from_model``: the partial outputs
all-reduced forward, identity backward) after the row-parallel ``proj`` and
``fc2``, before their bias. The replicated parameters (embedders, norms,
head, the biases of ``proj`` and ``fc2``) then get their whole gradient on
every model rank, and each split parameter its own slice's. A split
parameter carries its group as ``model_group``, from which
``train.common.ClippedAdamW`` takes the norm of the unsharded gradients.
``torch.distributed.nn.functional.all_reduce`` is not ``g``: its backward
all-reduces the gradient again, which would count a replicated gradient T
times. Each encoder layer's FFN dropout, which acts on the split ``fc1``
output, takes this rank's columns of a mask drawn at the full width
(``ffn_split``, read by ``nn/transformer.py:dropout``), so the split step
draws the masks of one process. DTensor's ``parallelize_module`` is not
used: the kernels take plain tensors.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from brepgen_tpu_torch.parallel.distributed import RowSplit


class _CopyToModel(torch.autograd.Function):
    """Megatron's ``f``: identity forward; the gradient summed over the
    ``model`` group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's ``g``: the partial outputs summed over the ``model`` group
    forward (in place on the fresh product); the gradient passed through
    backward."""

    @staticmethod
    def forward(ctx, y, group):
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        ctx.mark_dirty(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToModel.apply(x, group)


def reduce_from_model(y: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromModel.apply(y, group)


def _mark_split(param: nn.Parameter, dim: int, slices, group) -> None:
    """Tag a split parameter: its group, and the indices along ``dim`` of
    the unsharded tensor that each model rank holds (``gather_model``)."""
    param.model_group = group
    param.model_slice = (dim, slices)


class ColumnParallelLinear(nn.Linear):
    """The output rows ``slices[rank]`` of a full ``nn.Linear``, its input
    through ``f``: the product of a Linear whose output columns are split."""

    def __init__(self, linear: nn.Linear, slices, rank: int, group):
        rows = slices[rank]
        super().__init__(linear.in_features, len(rows), device=linear.weight.device,
                         dtype=linear.weight.dtype)
        with torch.no_grad():
            self.weight.copy_(linear.weight[rows])
            self.bias.copy_(linear.bias[rows])
        self.group = group
        for p in (self.weight, self.bias):
            _mark_split(p, 0, slices, group)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(copy_to_model(x, self.group), self.weight, self.bias)


class RowParallelLinear(nn.Module):
    """``x @ W[:, slices[rank]]^T`` summed over the ranks of ``group``
    (``g``), then the bias: the product of a full ``nn.Linear`` whose input
    columns are split. The bias is replicated."""

    def __init__(self, linear: nn.Linear, slices, rank: int, group):
        super().__init__()
        self.weight = nn.Parameter(linear.weight[:, slices[rank]].detach().clone())
        self.bias = nn.Parameter(linear.bias.detach().clone())
        _mark_split(self.weight, 1, slices, group)
        self.group = group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = reduce_from_model(F.linear(x, self.weight), self.group)
        return y + self.bias.to(y.dtype)


def all_gather(t: torch.Tensor, group) -> list:
    """``t`` of every rank of ``group``, in rank order; a CUDA tensor goes
    through host memory under gloo (its all_gather is the CPU one)."""
    host = t.device.type != "cpu" and dist.get_backend(group) == "gloo"
    src = t.detach().cpu() if host else t.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return [p.to(t.device) for p in parts] if host else parts


def gather_model(param: nn.Parameter, t: torch.Tensor) -> torch.Tensor:
    """The unsharded tensor of which ``t`` (``param``'s shape: the
    parameter, its gradient or an optimizer moment) is this rank's slice,
    gathered over ``param``'s model group; ``t`` itself for a replicated
    parameter. Every rank of the group calls it."""
    if getattr(param, "model_slice", None) is None:
        return t
    dim, slices = param.model_slice
    parts = all_gather(t, param.model_group)
    shape = list(t.shape)
    shape[dim] = sum(len(s) for s in slices)
    out = t.new_empty(shape)
    for idx, part in zip(slices, parts):
        out.index_copy_(dim, idx.to(t.device), part)
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
    width, ffn = attn.proj.out_features, layer.fc1.out_features
    if ffn % parts:
        raise ValueError(f"FFN width {ffn} does not split over {parts}")
    heads = [head_rows(width, attn.num_heads, r, parts) for r in range(parts)]
    cols = [torch.arange(r * width // parts, (r + 1) * width // parts) for r in range(parts)]
    hidden = [torch.arange(ffn)[RowSplit(r, parts).rows(ffn)] for r in range(parts)]
    attn.qkv = ColumnParallelLinear(attn.qkv, heads, rank, group)
    attn.proj = RowParallelLinear(attn.proj, cols, rank, group)  # its heads' columns
    attn.num_heads //= parts
    layer.fc1 = ColumnParallelLinear(layer.fc1, hidden, rank, group)
    layer.fc2 = RowParallelLinear(layer.fc2, hidden, rank, group)
    layer.ffn_split = RowSplit(rank, parts, group)
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
