"""Port: VAE training against the JAX package on the CPU.

The surface and edge VAEs at ``--small`` widths (channels 8) start from the
same parameters (seeded in the port, handed to JAX as its tree and loaded
back through ``weights.load_flax_params``); the port takes the posterior draws JAX's step
made from its key (``jax.random.normal(key, mean.shape)``) as ``eps``. Bars,
f32: loss, mse and kl within 1e-4 relative per step; parameters after three
steps of the VAE optimizer (global-norm clip 5.0, AdamW lr 5e-4, wd 1e-5)
within 1e-4; the eval step within 1e-4 relative. The batching and the
``--data_aug`` draws are array-equal; a pack the port's CLI writes decodes in
JAX as in the port (1e-5); ``--bf16`` gives a loss within 5e-3 relative of
f32 (about one bf16 rounding, 2^-8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brepgen_tpu.data.assembly import assemble_edge_u as j_assemble_edge_u
from brepgen_tpu.data.assembly import assemble_surf_uv as j_assemble_surf_uv
from brepgen_tpu.data.loader import flat_vae_batcher as j_flat_vae_batcher
from brepgen_tpu.nn import EdgeVAE as JEdgeVAE
from brepgen_tpu.nn import SurfVAE as JSurfVAE
from brepgen_tpu.train import common as jcommon
from brepgen_tpu.train import vae_train as jvt
from brepgen_tpu.train.checkpoint import load_params as j_load_params
from brepgen_tpu_torch.cli import vae_main
from brepgen_tpu_torch.cli.build import seed_weights
from brepgen_tpu_torch.data.loader import flat_vae_batcher
from brepgen_tpu_torch.data.synthetic import make_dataset
from brepgen_tpu_torch.nn import EdgeVAE, SurfVAE
from brepgen_tpu_torch.train import vae_train
from brepgen_tpu_torch.train.checkpoint import load_params
from brepgen_tpu_torch.train.common import TrainState, make_vae_optimizer
from brepgen_tpu_torch.weights import flatten_params, load_flax_params, to_flax_params

CHANNELS = {"surface": (8, 8, 8, 8), "edge": (8, 8, 8)}
GRID = {"surface": (32, 32, 3), "edge": (32, 3)}
LATENT = {"surface": (4, 4, 3), "edge": (4, 3)}


@pytest.fixture(autouse=True)
def one_thread():
    # one thread keeps the runs short on a loaded CPU
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _models(option):
    # seeded in the port and handed to JAX as its parameter tree (a flax init
    # traces the VAE op by op, about 10 s here); the port's module is then
    # loaded back from that tree
    j = (JSurfVAE if option == "surface" else JEdgeVAE)(block_out_channels=CHANNELS[option])
    cls = SurfVAE if option == "surface" else EdgeVAE
    params = to_flax_params(seed_weights(cls(CHANNELS[option]), torch.Generator().manual_seed(0)))
    return j, params, load_flax_params(cls(CHANNELS[option]), params)


def _grids(option, n, seed):
    key = "surf_ncs" if option == "surface" else "edge_ncs"
    arr = np.concatenate([d[key] for d in make_dataset(6, seed=seed)]).astype(np.float32)
    return arr[:n]


def _eps(rng, B, option):
    return torch.from_numpy(np.array(jax.random.normal(rng, (B,) + LATENT[option], jnp.float32)))


def _close(got, want, rel):
    return abs(float(got) - float(want)) <= rel * max(abs(float(want)), 1e-12)


LR = 5e-4
STEPS = 3


@pytest.fixture(scope="module", params=["surface", "edge"])
def trajectories(request):
    """Three train steps of each package from the same parameters and
    draws, and one eval step: (option, JAX's metrics, the port's, JAX's
    parameters, the port's, JAX's clipped gradients per step, the eval
    results)."""
    option = request.param
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    jmodel, params, tmodel = _models(option)
    opt = jcommon.make_vae_optimizer()
    jstate = jcommon.init_state(params, opt)
    jstep = jvt.make_train_step(jmodel, opt)
    state = TrainState(tmodel, make_vae_optimizer(tmodel.parameters()))
    step = vae_train.make_train_step(tmodel)
    jms, tms, grads, mu = [], [], [], None
    for i in range(STEPS):
        batch = _grids(option, 6, seed=i)
        rng = jax.random.PRNGKey(10 + i)
        jstate, jm = jstep(jstate, jnp.asarray(batch), rng)
        tms.append(step(state, torch.from_numpy(batch), eps=_eps(rng, len(batch), option)))
        jms.append(jm)
        # the clipped gradient of this step, from AdamW's first moment
        new_mu = {k: np.asarray(v) for k, v in
                  flatten_params(jax.device_get(jstate.opt_state[1][0].mu)).items()}
        grads.append({k: (v - 0.9 * (mu[k] if mu else 0.0)) / 0.1 for k, v in new_mu.items()})
        mu = new_mu
    assert state.step == STEPS == int(jstate.step)
    batch = _grids(option, 7, seed=4)
    rng = jax.random.PRNGKey(3)
    evals = (jvt.make_eval_step(jmodel)(jstate.params, jnp.asarray(batch), rng),
             vae_train.make_eval_step(tmodel)(torch.from_numpy(batch), eps=_eps(rng, 7, option)))
    want = {k: np.asarray(v) for k, v in flatten_params(jax.device_get(jstate.params)).items()}
    got = flatten_params(to_flax_params(tmodel))
    torch.set_num_threads(threads)
    return option, jms, tms, want, got, grads, evals, flatten_params(params)


def test_train_steps_match_jax(trajectories):
    # loss, mse and kl of every step; then the parameters after three steps
    # within 1e-4 wherever JAX's gradient exceeds 1e-6 in magnitude at every
    # step (100 x Adam's eps). Below that lie directions whose exact gradient
    # is zero, such as a convolution's bias ahead of a GroupNorm or the
    # attention's key bias: both packages compute rounding noise there, and
    # each Adam step moves such an element by up to lr in either package's
    # direction, so those elements are held to 2 * lr per step.
    option, jms, tms, want, got, grads, _, init = trajectories
    for i, (jm, tm) in enumerate(zip(jms, tms)):
        for k in ("loss", "mse", "kl"):
            assert _close(tm[k], jm[k], 1e-4), (option, i, k, float(tm[k]), float(jm[k]))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        diff = np.abs(got[k] - v)
        live = np.all([np.abs(g[k]) > 1e-6 for g in grads], axis=0)
        assert live.mean() > 0.5 or "bias" in k, k
        assert diff[live].max(initial=0.0) <= 1e-4, k
        assert diff.max() <= 2 * LR * STEPS, k
    assert any(not np.array_equal(got[k], init[k]) for k in got)


def test_eval_step_matches_jax(trajectories):
    option, *_, (want, got), _ = trajectories
    assert got.shape == () and _close(got, want, 1e-4), option


def test_flat_batcher_and_aug_batches_match_jax():
    grids = _grids("surface", 30, seed=1)
    jgen, tgen = j_flat_vae_batcher(grids, 8, seed=5), flat_vae_batcher(grids, 8, seed=5)
    for _ in range(2):  # two epochs: each draws the next permutation
        want, got = list(jgen()), list(tgen())
        assert len(got) == len(want) == 3  # 30 // 8, the partial batch dropped
        for a, b in zip(got, want):
            assert np.array_equal(a, b)

    # --data_aug: the JAX CLI's inline loop (vae_main.py:119-126) against the
    # port's batcher with its aug function, for both options
    for option, j_assemble in (("surface", j_assemble_surf_uv), ("edge", j_assemble_edge_u)):
        key = "surf_ncs" if option == "surface" else "edge_ncs"
        data = _grids(option, 20, seed=2)
        rng = np.random.default_rng(7)
        want = []
        for _ in range(2):
            order = rng.permutation(len(data))
            for start in range(0, len(order) - 6 + 1, 6):
                batch = data[order[start:start + 6]]
                want.append(np.stack([j_assemble({key: g[None]}, rng, aug=True)[0]
                                      for g in batch]))
        gen = flat_vae_batcher(data, 6, seed=7, aug_fn=vae_main.make_aug_fn(option))
        got = list(gen()) + list(gen())
        assert len(got) == len(want) == 6
        assert any(not np.array_equal(a, data[: len(a)]) for a in got)
        for a, b in zip(got, want):
            assert a.dtype == np.float32 and np.array_equal(a, b)


@pytest.mark.parametrize("option", ["surface", "edge"])
def test_cli_pack_decodes_in_jax(tmp_path, option):
    state = vae_main.main(["--small", "--synthetic", "12", "--option", option, "--device", "cpu",
                           "--batch_size", "8", "--train_nepoch", "2", "--test_nepoch", "1",
                           "--dir_name", str(tmp_path), "--env", option])
    assert state.step >= 2
    folder = tmp_path / option
    assert sorted(p.name for p in folder.iterdir()) == sorted(
        ["epoch_2.npz", "latest.pt", f"{option}.jsonl"])
    assert '"Val-mse"' in (folder / f"{option}.jsonl").read_text()
    pack = str(folder / "epoch_2.npz")
    jmodel = (JSurfVAE if option == "surface" else JEdgeVAE)(block_out_channels=CHANNELS[option])
    tmodel = load_params(pack, (SurfVAE if option == "surface" else EdgeVAE)(CHANNELS[option]))
    z = np.random.default_rng(0).normal(size=(3,) + LATENT[option]).astype(np.float32)
    want = jmodel.apply(j_load_params(pack), jnp.asarray(z), method=type(jmodel).decode)
    with torch.no_grad():
        got = tmodel.decode(torch.from_numpy(z))
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-5
    # the trained module itself decodes as its pack
    with torch.no_grad():
        assert torch.equal(state.module.decode(torch.from_numpy(z)), got)


def test_cli_resume_and_finetune(tmp_path):
    argv = ["--small", "--synthetic", "12", "--device", "cpu", "--batch_size", "8",
            "--train_nepoch", "1", "--test_nepoch", "1", "--dir_name", str(tmp_path)]
    first = vae_main.main(argv + ["--env", "a"])
    again = vae_main.main(argv + ["--env", "a", "--resume"])
    assert again.step == 2 * first.step > 0
    tuned = vae_main.main(argv + ["--env", "b", "--finetune", "--train_nepoch", "1",
                                  "--weight", str(tmp_path / "a" / "epoch_1.npz")])
    assert tuned.step == first.step


def test_small_set_trains_no_step(tmp_path):
    # the JAX CLI's drop-last loop: fewer items than a batch train no step
    state = vae_main.main(["--small", "--synthetic", "12", "--option", "edge", "--device", "cpu",
                           "--batch_size", "512", "--train_nepoch", "1", "--test_nepoch", "1",
                           "--dir_name", str(tmp_path), "--env", "e"])
    assert state.step == 0


def test_bf16_loss_near_f32():
    batch = torch.from_numpy(_grids("surface", 6, seed=0))
    eps = torch.randn((6,) + LATENT["surface"], generator=torch.Generator().manual_seed(1))
    losses = {}
    for dtype in (None, torch.bfloat16):
        _, _, model = _models("surface")
        state = TrainState(model, make_vae_optimizer(model.parameters()))
        losses[dtype] = float(vae_train.make_train_step(model, dtype)(state, batch, eps=eps)["loss"])
        assert all(p.dtype == torch.float32 for p in model.parameters())
    assert _close(losses[torch.bfloat16], losses[None], 5e-3)


def test_cli_refuses_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vae_main.main(["--small", "--synthetic", "4", "--dir_name", str(tmp_path)])
