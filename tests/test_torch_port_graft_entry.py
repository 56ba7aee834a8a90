"""Port: the entry check ``brepgen_tpu_torch/graft_entry.py`` against
``__graft_entry__.py``, on the CPU.

``entry()``'s forward of the flagship edgez denoiser (width 64, 4 heads:
head width 16) equals JAX's ``entry()`` forward at 1e-4 in f32, with the
port's seeded weights carried across by ``to_flax_params`` (the same tree as
JAX's init) and seeded non-zero inputs with padded slots (JAX's example
inputs are zeros). ``dryrun_multichip(4, device="cpu")`` runs 4 gloo ranks
(one torch thread each): its sampling leg, the tiny cascade split over the
4 ranks on ``data``, equals the unsharded cascade at rtol = atol = 1e-4 with
every output compared, and ``python -m brepgen_tpu_torch.graft_entry
--device cpu`` runs the entry and a world-size-1 dry run. The train leg's
bars are in ``tests/test_torch_port_tp_train.py``.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from brepgen_tpu_torch import graft_entry
from brepgen_tpu_torch.weights import to_flax_params

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_entry_matches_jax_entry():
    fn, (streams, t, mask) = graft_entry.entry(device="cpu")
    assert fn.encoder.layer_0.attn.num_heads == 4 and fn.encoder.layer_0.attn.qkv.out_features \
        == 3 * 64
    assert mask.any() and not mask.all() and all(bool((s != 0).all()) for s in streams)
    jfn, (jparams, jstreams, jt, jmask) = jentry.entry()
    params = to_flax_params(fn)
    assert jax.tree_util.tree_structure(params) == jax.tree_util.tree_structure(jparams)
    assert [s.shape for s in streams] == [tuple(s.shape) for s in jstreams]
    assert tuple(t.shape) == tuple(jt.shape) and tuple(mask.shape) == tuple(jmask.shape)
    with torch.no_grad():
        got = fn(streams, t, mask).numpy()
    want = np.asarray(jfn(params, tuple(jnp.asarray(s.numpy()) for s in streams),
                          jnp.asarray(t.numpy(), jnp.int32), jnp.asarray(mask.numpy())))
    assert got.shape == want.shape == (2, 12, 18)
    assert np.abs(got - want).max() <= 1e-4


def test_entry_refuses_the_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: entry() runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        graft_entry.dryrun_multichip(4)


@pytest.fixture(scope="module")
def dryrun():
    return graft_entry.dryrun_multichip(4, device="cpu")


def test_dryrun_sampling_leg_matches_unsharded(dryrun):
    # rank 0 held every output of the split run to the unsharded one at
    # rtol = atol = 1e-4 (an assertion there fails the rank and the dry run)
    rep = dryrun["sampling"]
    assert dryrun["backend"] == "gloo"
    assert rep["B"] == 4 and rep["k1_per_rank"] == [0, 0, 0, 0]  # the CPU: plain versions
    with torch.no_grad():
        want = graft_entry.tiny_cascade(4, "cpu")(
            graft_entry.GeneratorNoise(torch.Generator().manual_seed(0)))
    assert sorted(rep["diffs"]) == sorted(want) and rep["outputs"] == len(want)
    assert max(rep["diffs"].values()) == rep["max_abs_diff"] <= graft_entry.SAMPLING_TOL


def test_main_runs_entry_and_a_one_rank_dry_run():
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "brepgen_tpu_torch.graft_entry", "--device",
                           "cpu"], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "entry ok: (2, 12, 18)" in proc.stdout
    assert "dryrun_multichip[train]: mesh=(('data', 1), ('model', 1)) B=2" in proc.stdout
    assert "dryrun_multichip[sampling]: 1-way split cascade matches unsharded" in proc.stdout
