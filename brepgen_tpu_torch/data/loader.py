"""Host-side batching: shuffled epochs of assembled numpy batches, and a
background prefetch onto the training device.

The port's own copy of ``brepgen_tpu/data/loader.py``. Batches are
assembled by pure, picklable numpy functions (``assembly.py``,
``batch_assembly.py``) over in-memory samples or pkl paths; with
``num_workers > 0`` the per-sample path runs in a spawned process pool (each
worker holds its own copy of the sample list, tasks ship only
``(idx, seed)``). ``prefetch_to_device`` moves batches onto the card from a
background thread: pinned host tensors copied with ``non_blocking=True``,
so assembly and copies overlap the training step. Workers never touch
torch's CUDA state.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import queue as queue_mod
import threading
import warnings
from concurrent.futures import ProcessPoolExecutor
from typing import Callable, Iterable, Iterator, Optional, Sequence, Union

import numpy as np
import torch

Sample = Union[dict, str]


def _load(sample: Sample) -> dict:
    if isinstance(sample, dict):
        return sample
    with open(sample, "rb") as f:
        return pickle.load(f)


# Per-worker state, installed once by the pool initializer so that tasks
# are just (idx, seed) pairs — the torch-DataLoader-worker pattern.
_WORKER: dict = {}


def _pool_init(samples, assemble_fn):
    _WORKER["samples"] = samples
    _WORKER["assemble_fn"] = assemble_fn


def _pool_assemble(task):
    idx, seed = task
    rng = np.random.default_rng(seed)
    out = _WORKER["assemble_fn"](_load(_WORKER["samples"][idx]), rng)
    return out if isinstance(out, tuple) else (out,)


class Batcher:
    """Shuffled epoch iterator yielding tuples of stacked numpy arrays.

    assemble_fn(sample_dict, rng) -> array or tuple of arrays.
    class_labels: optional per-sample int labels (furniture); when given,
    each batch gets a trailing [B, 1] int32 array of label+1 (0 = uncond),
    matching reference ``dataset.py:276``.

    num_workers > 0 assembles in a spawned process pool (requires a
    picklable assemble_fn — module function or functools.partial); a
    non-picklable assemble_fn falls back to in-process assembly with a
    warning.

    batch_assemble_fn(samples, seeds) -> tuple of stacked [B, ...] arrays
    (``batch_assembly.py``): when given it replaces per-sample assembly
    with one vectorized call per batch — same distributions, exact same
    per-(sample, seed) draws — and the worker pool is not used (the
    vectorized path is faster than per-sample assembly on any core count).
    """

    def __init__(
        self,
        samples: Sequence[Sample],
        assemble_fn: Callable,
        batch_size: int,
        seed: int = 0,
        drop_last: bool = True,
        class_labels: Optional[Sequence[int]] = None,
        num_workers: int = 0,
        clamp_to_cpus: bool = True,
        batch_assemble_fn: Optional[Callable] = None,
    ):
        self.samples = list(samples)
        self.assemble_fn = assemble_fn
        self.batch_assemble_fn = batch_assemble_fn
        if batch_assemble_fn is not None:
            num_workers = 0  # vectorized path; no pool
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.class_labels = class_labels
        # A pool cannot beat in-process assembly without spare cores: clamp
        # to cpu_count-1 (one core stays with the consumer/device threads).

        avail = max((os.cpu_count() or 1) - 1, 0)
        self.num_workers = min(num_workers, avail) if clamp_to_cpus else num_workers
        self._rng = np.random.default_rng(seed)
        self._pool = None
        if self.num_workers > 0:
            try:
                pickle.dumps(assemble_fn)
            except Exception:
                warnings.warn(
                    "assemble_fn is not picklable; falling back to "
                    "in-process batch assembly (pass a module-level "
                    "function or functools.partial to use worker processes)"
                )
            else:
                # spawn (not fork): the parent holds a CUDA context and
                # threads; spawned workers start from a fresh import and
                # never touch the card.

                self._pool = ProcessPoolExecutor(
                    self.num_workers,
                    mp_context=multiprocessing.get_context("spawn"),
                    initializer=_pool_init,
                    initargs=(self.samples, assemble_fn),
                )

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None

    def __del__(self):  # best-effort; explicit close() preferred
        try:
            self.close()
        except Exception:
            pass

    def __len__(self):
        n = len(self.samples) // self.batch_size
        if not self.drop_last and len(self.samples) % self.batch_size:
            n += 1
        return n

    def _assemble_one(self, idx: int, seed: int):
        rng = np.random.default_rng(seed)
        out = self.assemble_fn(_load(self.samples[idx]), rng)
        return out if isinstance(out, tuple) else (out,)

    def __iter__(self):
        order = self._rng.permutation(len(self.samples))
        seeds = self._rng.integers(0, 2**63 - 1, size=len(order))
        for start in range(0, len(order), self.batch_size):
            idxs = order[start : start + self.batch_size]
            if self.drop_last and len(idxs) < self.batch_size:
                break
            batch_seeds = seeds[start : start + len(idxs)]
            if self.batch_assemble_fn is not None:
                batch = self.batch_assemble_fn(
                    [_load(self.samples[i]) for i in idxs], batch_seeds
                )
                if self.class_labels is not None:
                    labels = np.asarray(
                        [[self.class_labels[i] + 1] for i in idxs], np.int32
                    )
                    batch = tuple(batch) + (labels,)
                yield tuple(batch)
                continue
            if self._pool is not None:
                chunk = max(1, len(idxs) // (2 * self.num_workers))
                items = list(
                    self._pool.map(
                        _pool_assemble,
                        [(int(i), int(s)) for i, s in zip(idxs, batch_seeds)],
                        chunksize=chunk,
                    )
                )
            else:
                items = [
                    self._assemble_one(i, s) for i, s in zip(idxs, batch_seeds)
                ]
            batch = tuple(
                np.stack([it[k] for it in items]) for k in range(len(items[0]))
            )
            if self.class_labels is not None:
                labels = np.asarray(
                    [[self.class_labels[i] + 1] for i in idxs], np.int32
                )
                batch = batch + (labels,)
            yield batch


def flat_vae_batcher(grids: np.ndarray, batch_size: int, seed: int = 0,
                     aug_fn: Optional[Callable] = None) -> Callable[[], Iterator[np.ndarray]]:
    """Epoch iterator over a flat array of deduplicated VAE training items
    (the reference trains the VAEs on flat dedup arrays,
    ``dataset.py:145-151``): each call of the returned function is one
    epoch in the order of ``default_rng(seed)``'s next permutation, the last
    partial batch dropped; ``aug_fn(batch, rng)`` draws from the same rng."""
    rng = np.random.default_rng(seed)

    def gen():
        order = rng.permutation(len(grids))
        for start in range(0, len(order) - batch_size + 1, batch_size):
            batch = grids[order[start: start + batch_size]]
            if aug_fn is not None:
                batch = aug_fn(batch, rng)
            yield batch

    return gen


def prefetch_to_device(iterator: Iterable, device: torch.device,
                       lookahead: int = 2) -> Iterator:
    """Yield the batches of ``iterator`` (tuples or dicts of numpy arrays)
    as tensors on ``device``, produced by a background thread that keeps up
    to ``lookahead`` batches ahead: each array becomes a pinned host tensor
    copied with ``non_blocking=True`` on a stream of its own, which the
    consumer's stream waits for. A producer error is raised in the consumer;
    abandoning the generator stops the producer."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    copy_stream = torch.cuda.Stream(device) if on_card else None

    def put(batch):
        def one(a):
            t = torch.from_numpy(np.ascontiguousarray(a))
            if not on_card:
                return t.to(device)
            return t.pin_memory().to(device, non_blocking=True)

        if on_card:
            with torch.cuda.stream(copy_stream):
                out = _map(one, batch)
                event = torch.cuda.Event()
                event.record(copy_stream)
            return out, event
        return _map(one, batch), None

    q: "queue_mod.Queue" = queue_mod.Queue(maxsize=max(lookahead, 1))
    done = object()
    stop = threading.Event()
    err: list = []

    def offer(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue_mod.Full:
                continue
        return False

    def producer():
        try:
            for batch in iterator:
                if not offer(put(batch)):
                    return
        except BaseException as e:  # noqa: BLE001 -- re-raised in the consumer
            err.append(e)
        finally:
            offer(done)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is done:
                if err:
                    raise err[0]
                return
            batch, event = item
            if event is not None:
                torch.cuda.current_stream(device).wait_event(event)
                _map(lambda t: t.record_stream(torch.cuda.current_stream(device)), batch)
            yield batch
    finally:
        stop.set()
        thread.join(timeout=5.0)


def _map(fn, batch):
    if isinstance(batch, dict):
        return {k: fn(v) for k, v in batch.items()}
    return tuple(fn(v) for v in batch)
