"""Multi-GPU: process groups, the data-parallel split and tensor parallelism.

Port of ``brepgen_tpu/parallel/`` (``distributed.py``, ``mesh.py``,
``sharding_rules.py``); the package exports the JAX package's names that
have a PyTorch meaning (``mesh.py`` says why the two sharding annotations
are absent).
"""

from brepgen_tpu_torch.parallel.mesh import (
    data_parallel,
    data_split,
    make_mesh,
    replicate,
    shard_batch,
)

__all__ = ["make_mesh", "shard_batch", "replicate", "data_split", "data_parallel"]
