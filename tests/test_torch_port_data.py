"""Port: the numpy data path of training against the JAX package's.

The port keeps its own copies of ``data/synthetic.py``, ``schema.py``,
``pad.py``, ``augment.py``, ``assembly.py``, ``batch_assembly.py`` and the
``Batcher``: the same solids, the same draws per (sample, seed) and the same
batch order, so every array is equal, not close.
"""

import functools

import numpy as np
import pytest
import torch

from brepgen_tpu.data import assembly as jA
from brepgen_tpu.data import batch_assembly as jBA
from brepgen_tpu.data import loader as jloader
from brepgen_tpu.data import pad as jpad
from brepgen_tpu.data import synthetic as jsyn
from brepgen_tpu_torch.data import assembly as tA
from brepgen_tpu_torch.data import batch_assembly as tBA
from brepgen_tpu_torch.data import loader as tloader
from brepgen_tpu_torch.data import pad as tpad
from brepgen_tpu_torch.data import synthetic as tsyn
from brepgen_tpu_torch.data.schema import BREP_KEYS, validate_brep

MAX_FACE, MAX_EDGE = 12, 10


def _equal(a, b):
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == np.asarray(b).dtype and np.array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("family", ["all", "heldout"])
@pytest.mark.parametrize("seed", [0, 13])
def test_make_dataset_equals_jax(family, seed):
    got = tsyn.make_dataset(6, seed=seed, family=family)
    _equal(got, jsyn.make_dataset(6, seed=seed, family=family))
    for d in got:
        assert tuple(d) == BREP_KEYS
        validate_brep(d)


def test_pad_equals_jax():
    x = np.arange(21.0).reshape(7, 3)
    for n in (7, 9, 16):
        _equal(tpad.pad_repeat(x, n), jpad.pad_repeat(x, n))
        _equal(tpad.pad_zero(x, n, return_mask=True), jpad.pad_zero(x, n, return_mask=True))


def _samples():
    ds = tsyn.make_dataset(10, seed=3)
    return [d for d in ds if tA.filter_sample(d, MAX_FACE, MAX_EDGE, 3.0, 0.05)][:6]


STAGES = {
    "surfpos": (dict(max_face=MAX_FACE), tA.assemble_surfpos, jA.assemble_surfpos,
                tBA.assemble_surfpos_batched, jBA.assemble_surfpos_batched),
    "surfz": (dict(max_face=MAX_FACE), tA.assemble_surfz, jA.assemble_surfz,
              tBA.assemble_surfz_batched, jBA.assemble_surfz_batched),
    "edgepos": (dict(max_face=MAX_FACE, max_edge=MAX_EDGE), tA.assemble_edgepos,
                jA.assemble_edgepos, tBA.assemble_edgepos_batched, jBA.assemble_edgepos_batched),
    "edgez": (dict(max_face=MAX_FACE, max_edge=MAX_EDGE), tA.assemble_edgez,
              jA.assemble_edgez, tBA.assemble_edgez_batched, jBA.assemble_edgez_batched),
}


@pytest.mark.parametrize("aug", [False, True])
@pytest.mark.parametrize("stage", sorted(STAGES))
def test_assembly_equals_jax(stage, aug):
    kw, t_one, j_one, t_batch, j_batch = STAGES[stage]
    samples = _samples()
    assert len(samples) >= 4
    seeds = [11, 12, 13, 14, 15, 16][:len(samples)]
    for d, seed in zip(samples, seeds):
        _equal(t_one(d, np.random.default_rng(seed), aug=aug, **kw),
               j_one(d, np.random.default_rng(seed), aug=aug, **kw))
    _equal(t_batch(samples, seeds, aug=aug, **kw), j_batch(samples, seeds, aug=aug, **kw))


def test_filter_equals_jax():
    ds = tsyn.make_dataset(12, seed=5)
    for max_face, max_edge in ((6, 4), (12, 10)):
        assert ([tA.filter_sample(d, max_face, max_edge, 3.0, 0.05) for d in ds]
                == [jA.filter_sample(d, max_face, max_edge, 3.0, 0.05) for d in ds])


@pytest.mark.parametrize("batched", [False, True])
def test_batcher_order_equals_jax(batched):
    samples = _samples()
    kw = dict(max_face=MAX_FACE, bbox_scaled=3.0, aug=True)
    args = dict(batch_size=2, seed=4, class_labels=[3, 1, 4, 1, 5, 9][:len(samples)])
    if batched:
        tb = tloader.Batcher(samples, None, batch_assemble_fn=functools.partial(
            tBA.assemble_surfz_batched, **kw), **args)
        jb = jloader.Batcher(samples, None, batch_assemble_fn=functools.partial(
            jBA.assemble_surfz_batched, **kw), **args)
    else:
        tb = tloader.Batcher(samples, functools.partial(tA.assemble_surfz, **kw), **args)
        jb = jloader.Batcher(samples, functools.partial(jA.assemble_surfz, **kw), **args)
    for _ in range(2):  # two epochs: the epoch order draws from one generator
        got, want = list(tb), list(jb)
        assert len(got) == len(want) == len(samples) // 2
        _equal(got, want)


def test_prefetch_to_device_keeps_order_and_types():
    batches = [(np.full((2, 3), i, np.float32), np.array([[i]], np.int32),
                np.zeros((2,), bool)) for i in range(5)]
    got = list(tloader.prefetch_to_device(iter(batches), torch.device("cpu"), lookahead=2))
    assert len(got) == 5
    for i, (a, b, c) in enumerate(got):
        assert torch.equal(a, torch.full((2, 3), float(i)))
        assert b.dtype == torch.int32 and int(b) == i and c.dtype == torch.bool
    dicts = list(tloader.prefetch_to_device(iter([{"x": np.ones(3)}]), torch.device("cpu")))
    assert torch.equal(dicts[0]["x"], torch.ones(3, dtype=torch.float64))


def test_prefetch_raises_the_producer_error_and_stops_early():
    def bad():
        yield (np.zeros(1),)
        raise OSError("disk")

    it = tloader.prefetch_to_device(bad(), torch.device("cpu"))
    next(it)
    with pytest.raises(OSError, match="disk"):
        next(it)
    endless = ((np.zeros(1),) for _ in iter(int, 1))
    it = tloader.prefetch_to_device(endless, torch.device("cpu"), lookahead=1)
    next(it)
    it.close()  # the producer thread stops instead of blocking on a full queue


def test_batcher_worker_pool_equals_in_process():
    # the per-sample path in two spawned worker processes: the same batches
    samples = _samples()
    fn = functools.partial(tA.assemble_edgez, max_face=MAX_FACE, max_edge=MAX_EDGE, aug=True)
    pooled = tloader.Batcher(samples, fn, 3, seed=2, num_workers=2, clamp_to_cpus=False)
    try:
        got = list(pooled)
    finally:
        pooled.close()
    jfn = functools.partial(jA.assemble_edgez, max_face=MAX_FACE, max_edge=MAX_EDGE, aug=True)
    _equal(got, list(jloader.Batcher(samples, jfn, 3, seed=2)))
