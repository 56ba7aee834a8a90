"""Process groups for multi-GPU runs, and the split of a global batch by rank.

Port of ``brepgen_tpu/parallel/distributed.py``. JAX joins a multi-host run
from COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID; PyTorch's counterpart
is the environment ``torchrun`` (``python -m torch.distributed.run``) sets
for each process: MASTER_ADDR and MASTER_PORT (the coordinator's address),
WORLD_SIZE (the number of processes), RANK (this process's id) and
LOCAL_RANK (its card on its host). JAX runs one process per host driving
every local device; here each process drives one card, so a host with N
cards runs ``torchrun --nproc_per_node N``. ``maybe_initialize_distributed``
joins the group when that environment is present; the per-host shard of a
sample list becomes the per-rank shard (``shard_list_for_rank``).

``RowSplit`` is how the port keeps a data-parallel run equal to the
single-process one: every rank draws what the whole batch would draw (from
the same seeded generator) and keeps its own contiguous rows, so the ranks'
union is the single-process batch.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

TORCHRUN_ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
TORCHRUN_HINT = "torchrun --nproc_per_node N"


def launched() -> bool:
    """Whether this process was started by torchrun (its environment is set)."""
    return all(os.environ.get(k) for k in TORCHRUN_ENV)


def maybe_initialize_distributed(backend: Optional[str] = None,
                                 device: str | torch.device = "cuda") -> bool:
    """Join the process group torchrun describes; returns whether a group is
    initialised (already, or now). World size 1 under torchrun counts, so the
    data-parallel path runs on one card as well.

    The backend is ``nccl`` for a CUDA ``device`` and ``gloo`` for the CPU;
    the caller may name ``gloo`` on the card (several ranks sharing one card,
    which NCCL refuses). A CUDA device selects card ``LOCAL_RANK`` (with gloo,
    ``LOCAL_RANK`` modulo the visible cards). Nothing falls back: a CUDA
    device without a card, or NCCL without one card per rank, raises.
    """
    if in_group():
        return True
    if not launched():
        return False
    device = torch.device(device)
    cuda = device.type == "cuda"
    backend = backend or ("nccl" if cuda else "gloo")
    if cuda:
        cards = torch.cuda.device_count()
        if not cards:
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the "
                               "CPU (gloo)")
        local = int(os.environ["LOCAL_RANK"])
        if backend == "nccl" and local >= cards:
            raise RuntimeError(f"LOCAL_RANK {local} has no card of its own ({cards} visible): "
                               "NCCL needs one card per rank; name backend 'gloo' to share one")
        torch.cuda.set_device(local % cards)
    elif backend == "nccl":
        raise RuntimeError("the nccl backend needs a CUDA device")
    dist.init_process_group(backend)
    return True


def in_group() -> bool:
    """Whether this process has joined a process group."""
    return dist.is_available() and dist.is_initialized()


def rank_and_world() -> tuple[int, int]:
    """(rank, world size) of the default group; (0, 1) without one."""
    return (dist.get_rank(), dist.get_world_size()) if in_group() else (0, 1)


def shard_list_for_rank(items: Sequence) -> list:
    """This rank's contiguous share of ``items``; the remainder is dropped so
    that every rank holds as many (``shard_list_for_host`` by rank)."""
    rank, world = rank_and_world()
    if world == 1:
        return list(items)
    per = len(items) // world
    return list(items[rank * per:(rank + 1) * per])


@dataclasses.dataclass(frozen=True)
class RowSplit:
    """This rank's rows of a global batch: rank ``rank`` of ``world`` holds
    the rows ``rows(n)`` of a batch of ``n`` rows, the contiguous split of
    ``numpy.array_split`` (equal shares when ``world`` divides ``n``).
    ``group`` is the process group of the ``world`` ranks that split the
    batch (None: the default group); on a data x model mesh it is the
    ``data`` axis's, whose sums (``all_reduce_sum``) leave the model ranks
    holding the same rows apart."""

    rank: int
    world: int
    group: Optional[object] = dataclasses.field(default=None, compare=False, repr=False)

    @classmethod
    def of_group(cls) -> Optional["RowSplit"]:
        """The split of the default group, or None without one."""
        return cls(*rank_and_world()) if in_group() else None

    def rows(self, n: int) -> slice:
        per, extra = divmod(n, self.world)
        start = self.rank * per + min(self.rank, extra)
        return slice(start, start + per + (self.rank < extra))

    def take(self, x):
        """This rank's rows of ``x`` (any array or tensor, along dim 0)."""
        return x[self.rows(x.shape[0])]

    def global_rows(self, local: int) -> int:
        """The global batch of an equal split with ``local`` rows a rank."""
        return local * self.world


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` summed over ``group`` (default: the default group), in place;
    ``x`` without a process group."""
    if in_group():
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def all_reduce_max(value: int, device: str | torch.device = "cpu") -> int:
    """The largest ``value`` of any rank; ``value`` without a group."""
    if not in_group():
        return value
    t = torch.tensor([value], dtype=torch.long, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return int(t.item())


def barrier() -> None:
    """Wait for every rank of the default group; nothing without one."""
    if in_group():
        dist.barrier()
