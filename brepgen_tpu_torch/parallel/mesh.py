"""Device mesh and the data-parallel placement of batches and modules.

Port of ``brepgen_tpu/parallel/mesh.py``. JAX places one jitted train step
over a ``jax.sharding.Mesh``, batch sharded on ``data``, parameters
replicated, and XLA inserts the gradient all-reduce. In PyTorch each rank is
a process holding one card: ``make_mesh`` names the ranks of the process
group as a ``torch.distributed.device_mesh.DeviceMesh`` with the same axes,
``shard_batch`` keeps this rank's rows of the global batch and ``replicate``
broadcasts a module's parameters and buffers from rank 0; the gradient
all-reduce is ``DistributedDataParallel``'s (``train/loop.py``), and the
``model`` axis is used by ``sharding_rules.shard_denoiser``.

Axes:
  data   -- batch split (gradient all-reduce by DistributedDataParallel)
  model  -- tensor split of the attention heads and FFN (``sharding_rules``)

``batch_sharding`` and ``replicated_sharding`` of the JAX module are
absent: they build ``NamedSharding`` annotations that XLA reads to place
arrays, and a torch tensor has no such annotation (a rank holds a plain
tensor; ``shard_batch`` and ``replicate`` do the placing themselves).
"""

from __future__ import annotations

import math
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from brepgen_tpu_torch.parallel.distributed import RowSplit, rank_and_world


def make_mesh(axis_shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ("data", "model"),
              device_type: Optional[str] = None):
    """A ``DeviceMesh`` of ``axis_shape`` over the ranks of the default group
    (default: every rank on ``data``); its product must equal the world size.
    ``device_type`` defaults to "cuda" where a card is visible."""
    _, n = rank_and_world()
    if axis_shape is None:
        axis_shape = (n,) + (1,) * (len(axis_names) - 1)
    assert math.prod(axis_shape) == n, f"{axis_shape} != {n} ranks"
    from torch.distributed.device_mesh import init_device_mesh

    device_type = device_type or ("cuda" if torch.cuda.is_available() else "cpu")
    return init_device_mesh(device_type, tuple(axis_shape), mesh_dim_names=tuple(axis_names))


def _data_split(mesh) -> RowSplit:
    return RowSplit(mesh.get_local_rank("data"), mesh.size(mesh.mesh_dim_names.index("data")))


def shard_batch(batch: Any, mesh) -> Any:
    """This rank's contiguous rows (dim 0) of every tensor or array of
    ``batch`` (a tensor, or a dict / tuple / list of them), split over the
    mesh's ``data`` axis."""
    split = _data_split(mesh)
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(v, mesh) for v in batch)
    return split.take(batch)


@torch.no_grad()
def replicate(module: nn.Module, mesh) -> nn.Module:
    """Broadcast ``module``'s parameters and buffers from rank 0 to every
    rank of the mesh (the whole default group), in place; returns
    ``module``."""
    assert mesh.size() == dist.get_world_size(), "the mesh must cover every rank"
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=0)
    return module
