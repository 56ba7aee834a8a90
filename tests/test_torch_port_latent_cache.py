"""Port: the frozen-VAE latent cache (``--cache_latents``) on the CPU.

The port of ``tests/test_train.py::test_latent_cache_and_cached_step_equivalence``:
``LatentCache`` returns the frozen encode (1e-5, the JAX test's bar; the
cache encodes in buckets of another batch size, and the CPU's convolutions
round differently across batch sizes, about 3e-6 here) on every grid that is
not constant, with the hit and miss counts of JAX's cache on the same grids.
The constant grids are the zeros of the padded slots: their first GroupNorm
divides rounding noise by sqrt(eps), so their latents depend on the batch
they are encoded in, in either package, and the steps mask them. surfz and
edgez steps fed the cached latents give the loss (1e-5 relative, as in JAX)
and the gradients (1e-5 of each tensor's largest) of the steps that encode
in the step, from the same draws. The CLI refuses ``--cache_latents --data_aug`` with the
reference's message, and a cached CLI run hits.
"""

import numpy as np
import pytest
import torch

from brepgen_tpu.data.latent_cache import LatentCache as JLatentCache
from brepgen_tpu_torch.cli import ldm_main
from brepgen_tpu_torch.cli.build import seed_weights
from brepgen_tpu_torch.data.latent_cache import LatentCache
from brepgen_tpu_torch.diffusion.ddpm import make_ddpm_tables
from brepgen_tpu_torch.nn import EdgeVAE, SurfVAE
from brepgen_tpu_torch.nn import denoiser as tden
from brepgen_tpu_torch.train import ldm_train
from brepgen_tpu_torch.train.checkpoint import save_params_npz
from brepgen_tpu_torch.train.common import TrainState
from test_torch_port_train import MAX_EDGE, MAX_FACE, SMALL, _batch, _vaes


@pytest.fixture(autouse=True)
def one_thread():
    # one thread keeps the runs short on a loaded CPU
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def vaes():
    return _vaes()


class GradCapture:
    """An optimizer stand-in: keeps the gradients of one step."""

    def __init__(self, module):
        self.module, self.grads = module, None

    def step(self):
        self.grads = {k: p.grad.detach().clone() for k, p in self.module.named_parameters()
                      if p.grad is not None}
        self.module.zero_grad(set_to_none=True)


def test_cache_returns_the_frozen_encode_with_jax_counts(vaes):
    (j_se, j_sp, j_ee, j_ep), (surf_encode, edge_encode) = vaes
    batch = _batch("edgez", seed=3)
    B, nf, ne = batch["edgepnt"].shape[:3]
    cases = ((batch["surfpnt"].reshape(B * nf, 32, 32, 3), surf_encode, j_se, j_sp, 48),
             (batch["edgepnt"].reshape(B * nf * ne, 32, 3), edge_encode, j_ee, j_ep, 12))
    for grids, encode, j_encode, j_params, dim in cases:
        cache = LatentCache(encode, grids.shape[1:], dim, bucket=16, device="cpu")
        jcache = JLatentCache(j_encode, j_params, grids.shape[1:], dim, bucket=16)
        got, want = cache(grids), jcache(grids)
        direct = encode(torch.from_numpy(grids)).reshape(len(grids), -1).numpy()
        assert got.dtype == np.float32 and got.shape == (len(grids), dim)
        flat = grids.reshape(len(grids), -1)
        live = flat.max(1) > flat.min(1)
        assert 0 < live.sum() < len(grids) and not flat[~live].any()
        assert np.abs(got - direct)[live].max() <= 1e-5
        assert np.abs(got - want)[live].max() <= 1e-5
        # padding repeats grids within the batch: those hit on first sight
        assert (cache.hits, cache.misses) == (jcache.hits, jcache.misses)
        assert 0 < cache.misses < len(grids) and len(cache) == cache.misses
        again = cache(grids)
        assert np.array_equal(again, got) and cache.misses == jcache.misses
        assert cache.hits == jcache.hits + len(grids)
    with pytest.raises(ValueError, match="expected"):
        cache(np.zeros((2, 31, 3), np.float32))


@pytest.mark.parametrize("stage", ["surfz", "edgez"])
def test_cached_step_equals_the_encoding_step(vaes, stage):
    _, (surf_encode, edge_encode) = vaes
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in _batch(stage, seed=5).items()}
    cached = dict(batch)
    B, nf = batch["surfpnt"].shape[:2]
    surf_cache = LatentCache(surf_encode, (32, 32, 3), 48, bucket=16, device="cpu")
    cached["surfz"] = torch.from_numpy(
        surf_cache(batch["surfpnt"].reshape(B * nf, 32, 32, 3).numpy()).reshape(B, nf, 48))
    del cached["surfpnt"]
    if stage == "edgez":
        ne = batch["edgepnt"].shape[2]
        edge_cache = LatentCache(edge_encode, (32, 3), 12, bucket=16, device="cpu")
        cached["edgez"] = torch.from_numpy(edge_cache(
            batch["edgepnt"].reshape(-1, 32, 3).numpy()).reshape(B, nf, ne, 12))
        del cached["edgepnt"]
    out = {}
    for name, b in (("encoded", batch), ("cached", cached)):
        net = seed_weights(getattr(tden, f"make_{stage}_net")(attn_impl="kernel", **SMALL),
                           torch.Generator().manual_seed(1))
        capture = GradCapture(net)
        step = ldm_train.make_step(stage, net, make_ddpm_tables(), surf_encode, edge_encode)
        m = step(TrainState(net, capture), b, torch.Generator().manual_seed(2))
        out[name] = (float(m["loss"]), capture.grads)
    (loss_e, g_e), (loss_c, g_c) = out["encoded"], out["cached"]
    assert abs(loss_c - loss_e) <= 1e-5 * abs(loss_e)
    assert sorted(g_c) == sorted(g_e)
    for k, g in g_e.items():
        assert (g_c[k] - g).abs().max() <= 1e-5 * max(g.abs().max().item(), 1e-12), k


@pytest.fixture(scope="module")
def vae_packs(tmp_path_factory):
    folder = tmp_path_factory.mktemp("vaes")
    gen = torch.Generator().manual_seed(0)
    return (save_params_npz(str(folder), seed_weights(SurfVAE((8, 8, 8, 8)), gen), "surfvae"),
            save_params_npz(str(folder), seed_weights(EdgeVAE((8, 8, 8)), gen), "edgevae"))


def _argv(tmp_path, vae_packs, *extra):
    return ["--small", "--synthetic", "8", "--option", "edgez", "--train_nepoch", "2",
            "--device", "cpu", "--batch_size", "4", "--max_face", str(MAX_FACE), "--max_edge",
            str(MAX_EDGE), "--num_workers", "0", "--test_nepoch", "2", "--surfvae", vae_packs[0],
            "--edgevae", vae_packs[1], "--dir_name", str(tmp_path), "--env", "edgez", *extra]


def test_cli_refuses_cache_with_data_aug(tmp_path, vae_packs):
    # the reference's message (brepgen_tpu/cli/ldm_main.py:314-317)
    with pytest.raises(SystemExit, match="--cache_latents requires --data_aug off"):
        ldm_main.main(_argv(tmp_path, vae_packs, "--cache_latents", "--data_aug"))


def test_cli_cached_run_hits_and_trains_as_the_encoding_run(tmp_path, vae_packs):
    runs = {}
    for flag in ([], ["--cache_latents"]):
        runs[bool(flag)] = ldm_main.train(ldm_main.get_args(_argv(tmp_path, vae_packs, *flag)))
    plain, cached = runs[False], runs[True]
    assert plain.surf_cache is None and cached.state.step == plain.state.step == 4
    for cache in (cached.surf_cache, cached.edge_cache):
        # two epochs over the same 8 solids plus two validation passes: the
        # grids of the second epoch and of validation repeats all hit
        assert cache.hits > cache.misses > 0 and len(cache) == cache.misses
    for (k, p), q in zip(plain.state.module.named_parameters(),
                         cached.state.module.parameters()):
        assert (p - q).abs().max() <= 2 * 5e-4 * 4, k  # Adam's lr per step, 4 steps
