"""Port: tensor-parallel training (``parallel/sharding_rules.py``'s Megatron
operators, ``train/common.py``'s norm of the unsharded gradients, the FFN
dropout's column split) on the CPU.

``dryrun_multichip(4, device="cpu")`` (``brepgen_tpu_torch/graft_entry.py``)
takes the edgez step of ``__graft_entry__.py``'s dry run on a 2 x 2 data x
model mesh of gloo ranks (one torch thread a rank), dropout on, and rank 0
the same step in one process. Held, with the bars of
``tests/test_torch_port_parallel.py::test_ddp_step_matches_single_process``:
the metrics (rtol 1e-5), the clip norm (rtol 1e-5), every clipped gradient
gathered over ``model`` (atol 1e-6), the parameters after the update where
the gradient is resolved (atol 2.5e-4; elsewhere 2 lr), and the gradients of
the replicated parameters (norms, embedders, head, the row-parallel biases)
equal on the two model ranks. The single-process step at world size 1
equals JAX's ``make_edgez_step`` with JAX's draws replayed (dropout 0 in
both: its masks cannot be shared), with ``tests/test_torch_port_train.py``'s
bars.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brepgen_tpu.diffusion import make_ddpm_tables as j_tables
from brepgen_tpu.nn import EdgeVAE as JEdgeVAE
from brepgen_tpu.nn import SurfVAE as JSurfVAE
from brepgen_tpu.nn import denoiser as jden
from brepgen_tpu.train import common as jcommon
from brepgen_tpu.train import ldm_train as jlt
from brepgen_tpu.train.vae_train import make_encoder_fn as j_encoder
from brepgen_tpu_torch import graft_entry
from brepgen_tpu_torch.nn.transformer import dropout
from brepgen_tpu_torch.parallel.distributed import RowSplit
from brepgen_tpu_torch.weights import flatten_params, to_flax_params
from test_torch_port_train import _flat_jax, _jax_draws, _torch_grads_flax

LR = 5e-4


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def train():
    return graft_entry.dryrun_multichip(4, device="cpu")["train"]


def test_tp_step_matches_one_process(train):
    assert train["mesh"] == [["data", 2], ["model", 2]] and train["B"] == 4
    assert sorted(train["metrics"]) == sorted(train["ref_metrics"]) == ["loss", "loss_v",
                                                                          "loss_z"]
    for k, v in train["ref_metrics"].items():
        np.testing.assert_allclose(train["metrics"][k], v, rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(train["norm"], train["ref_norm"], rtol=1e-5)
    assert train["ref_norm"] > 0


def test_tp_gradients_and_update_match_one_process(train):
    names = train["grad_diff"]
    # every parameter of the denoiser, the split ones gathered over model
    assert any(".attn.qkv." in k for k in names) and any(".fc2.weight" in k for k in names)
    assert len(names) == len(train["param_diff"])
    for k, d in names.items():
        assert d <= 1e-6, (k, d)
    for k, d in train["param_diff"].items():
        assert d <= 2.5e-4, (k, d)
    assert train["param_max_abs_diff_unresolved"] <= 2 * LR


def test_replicated_gradients_are_equal_on_the_model_ranks(train):
    assert train["replicated_grad_max_diff"] == 0.0


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_ffn_dropout_takes_its_columns_of_the_full_mask(rate):
    # the masks of two model ranks, each on its FFN columns (and a data
    # split of the rows), are the single-process mask's slices
    x = torch.randn((4, 6, 8), generator=torch.Generator().manual_seed(0)) + 3.0
    full = dropout(x, rate, torch.Generator().manual_seed(5))
    rows = RowSplit(1, 2)
    for r in range(2):
        cols = RowSplit(r, 2)
        part = dropout(rows.take(x)[..., cols.rows(8)], rate, torch.Generator().manual_seed(5),
                       row_split=rows, col_split=cols)
        torch.testing.assert_close(part, rows.take(full)[..., cols.rows(8)], rtol=0, atol=0)


def test_one_process_step_matches_jax_make_edgez_step():
    batch = graft_entry.train_batch(2)
    net, surf_vae, edge_vae = graft_entry.train_models("cpu", dropout=0.0)
    params = to_flax_params(net)
    js, je = JSurfVAE(block_out_channels=(4, 4, 4, 4)), JEdgeVAE(block_out_channels=(4, 4, 4))
    jvae = (j_encoder(js), to_flax_params(surf_vae), j_encoder(je), to_flax_params(edge_vae))
    jmodel = jden.make_edgez_net(dropout=0.0, **graft_entry.FLAGSHIP)
    rng = jax.random.PRNGKey(1)
    draws = _jax_draws("edgez", jmodel, params, rng, batch, jvae, False)
    opt = jcommon.make_ldm_optimizer()
    jstate, jm = jlt.make_edgez_step(jmodel, opt, j_tables(), *jvae)(
        jcommon.init_state(params, opt), {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    tnet, state, tm = graft_entry.train_step(batch, "cpu", draws=draws, dropout=0.0)
    for k in ("loss", "loss_z", "loss_v"):
        assert abs(tm[k] - float(jm[k])) <= 1e-5, k
    b1 = graft_entry.B1
    jgrads = {k: v / (1 - b1) for k, v in _flat_jax(jstate.opt_state[1][0].mu).items()}
    tgrads = _torch_grads_flax(tnet, graft_entry.clipped_grads(state))
    assert set(tgrads) == set(jgrads)
    for k, g in jgrads.items():
        assert np.abs(tgrads[k] - g).max() <= 1e-4, k
    got = flatten_params(to_flax_params(tnet))
    for k, v in _flat_jax(jstate.params).items():
        diff = np.abs(got[k] - v)
        live = np.abs(jgrads[k]) > 1e-6
        assert diff[live].max(initial=0.0) <= 1e-4, k
        assert diff.max() <= 2 * LR, k
