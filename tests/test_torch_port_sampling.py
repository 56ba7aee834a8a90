"""Port: dedup and the whole cascade against the JAX package.

The cascade runs at a tiny architecture (width 32, 2 heads, 1 layer; B=2,
ns0=4, ne=3) in DDIM fast mode and in a short PNDM + DDPM protocol, the
latter also class-conditional (CFG by batch doubling, no late increase). The
port's noise source replays JAX's draws: the key split of ``cascade.py``'s
``cascade`` and ``s_surfpos``/``s_edgepos``, the per-segment ``fold_in`` of
the DDPM tails and the per-step split of ``ddpm_scan``. Masks must be
identical; values agree to 1e-4 (CPU, f32).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brepgen_tpu.nn import EdgeVAE as JEdgeVAE
from brepgen_tpu.nn import SurfVAE as JSurfVAE
from brepgen_tpu.nn import denoiser as jden
from brepgen_tpu.sampling import CascadeConfig as JCascadeConfig
from brepgen_tpu.sampling import build_cascade
from brepgen_tpu.sampling import dedup_bboxes as j_dedup_bboxes
from brepgen_tpu.sampling import dedup_edges_per_face as j_dedup_edges
from brepgen_tpu_torch import nn as tnn
from brepgen_tpu_torch.diffusion import make_ddim_plan
from brepgen_tpu_torch.sampling import Cascade, CascadeConfig, dedup_bboxes, dedup_edges_per_face
from brepgen_tpu_torch.cli.build import seed_weights
from brepgen_tpu_torch.weights import to_flax_params

SMALL = dict(width=32, num_heads=2, ffn_width=64, num_layers=1)
STREAMS = {
    "surfpos": (6,), "surfz": (48, 6), "edgepos": (6, 6, 48), "edgez": (12, 6, 6, 6, 48),
}


def _boxes_with_duplicates(shape, seed):
    """Random boxes where some slots copy an earlier one, perturbed below
    the threshold, some with their corners swapped."""
    rng = np.random.default_rng(seed)
    b = rng.normal(size=shape + (6,)).astype(np.float32)
    flat = b.reshape(-1, shape[-1], 6)
    for row in flat:
        for i in range(1, shape[-1]):
            u = rng.random()
            if u < 0.4:
                j = rng.integers(0, i)
                row[i] = row[j] + rng.uniform(-0.05, 0.05, 6)
                if u < 0.2:
                    row[i] = np.concatenate([row[i][3:], row[i][:3]])
    return b


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dedup_bboxes_identical(seed):
    b = _boxes_with_duplicates((4, 12), seed)
    want = np.asarray(j_dedup_bboxes(jnp.asarray(b), 0.08))
    got = dedup_bboxes(torch.from_numpy(b), 0.08).numpy()
    assert got[:, 0].all()
    assert 0 < (~got).sum()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_dedup_edges_per_face_identical(seed):
    b = _boxes_with_duplicates((2, 5, 6), seed)
    surf_keep = np.random.default_rng(seed).random((2, 5)) < 0.7
    surf_keep[:, 0] = True
    want = np.asarray(j_dedup_edges(jnp.asarray(b), jnp.asarray(surf_keep), 0.08))
    got = dedup_edges_per_face(torch.from_numpy(b), torch.from_numpy(surf_keep), 0.08).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[~surf_keep].any()


class JaxDraws:
    """The port's noise source, replaying the draws of the JAX cascade."""

    def __init__(self, key, cfg: JCascadeConfig, surfpos_tail: int):
        keys = jax.random.split(key, 8)
        self.keys = keys
        self.k0, self.k1 = jax.random.split(keys[0])
        self.seg = cfg.seg_calls
        self.tails = {"surfpos_ddpm": (self.k1, surfpos_tail),
                      "edgepos_ddpm": (jax.random.fold_in(keys[3], 1), cfg.ddpm_tail)}
        self.inits = {"surfpos": self.k0, "surfz": keys[2], "edgepos": keys[3], "edgez": keys[5]}

    @functools.lru_cache(maxsize=None)
    def _segment_keys(self, site, seg):
        base, total = self.tails[site]
        n = min(self.seg, total - seg * self.seg)
        return jax.random.split(jax.random.fold_in(base, seg), n)

    def __call__(self, site, shape, step=None):
        if step is None:
            key = self.inits[site]
        else:
            seg, j = divmod(step, self.seg)
            key = self._segment_keys(site, seg)[j]
        return torch.from_numpy(np.array(jax.random.normal(key, shape, dtype=jnp.float32)))


@functools.lru_cache(maxsize=None)
def _models(use_cf):
    """Tiny port denoisers and VAEs with seeded weights, and the JAX side
    with the same weights (``to_flax_params``)."""
    gen = torch.Generator().manual_seed(0)
    nets, params, port = {}, {}, {}
    for stage in STREAMS:
        attn = "kernel" if stage.startswith("edge") else "plain"
        port[stage] = seed_weights(
            getattr(tnn, f"make_{stage}_net")(use_cf=use_cf, attn_impl=attn, **SMALL), gen).eval()
        nets[stage] = getattr(jden, f"make_{stage}_net")(use_cf=use_cf, **SMALL)
        params[stage] = to_flax_params(port[stage])
    t_surf = seed_weights(tnn.SurfVAE((4, 4, 4, 4)), gen).eval()
    t_edge = seed_weights(tnn.EdgeVAE((4, 4, 4)), gen).eval()
    surf_vae, edge_vae = JSurfVAE(block_out_channels=(4, 4, 4, 4)), JEdgeVAE(block_out_channels=(4, 4, 4))
    jax_side = (nets, params,
                lambda p, z: surf_vae.apply(p, z, method=JSurfVAE.decode), to_flax_params(t_surf),
                lambda p, z: edge_vae.apply(p, z, method=JEdgeVAE.decode), to_flax_params(t_edge))
    return jax_side, (port, t_surf, t_edge)


@pytest.mark.parametrize("fast_steps,use_cf", [(4, False), (0, False), (0, True)])
def test_cascade_matches_jax(fast_steps, use_cf):
    models = _models(use_cf)
    cfg_kw = dict(batch_size=2, num_surfaces=4, num_edges=3, pndm_steps=10,
                  pos_pndm_calls=8, ddpm_tail=5, fast_steps=fast_steps,
                  use_cf=use_cf, class_label=6)
    jcfg = JCascadeConfig(**cfg_kw)
    jcascade = build_cascade(*models[0], jcfg)
    tcascade = Cascade(*models[1], CascadeConfig(**cfg_kw))
    key = jax.random.PRNGKey(3)
    want = {k: np.asarray(v) for k, v in jcascade(key).items()}
    if fast_steps:
        plan = make_ddim_plan(fast_steps)
        surfpos_tail = int(plan.t[max(fast_steps * 3 // 4, 1) - 1])
    else:
        surfpos_tail = jcfg.ddpm_tail
    got = {k: v.numpy() for k, v in tcascade(JaxDraws(key, jcfg, surfpos_tail)).items()}
    assert sorted(got) == sorted(want)
    for k in ("surf_mask", "edge_mask"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in got:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=0, err_msg=k)
    calls = tcascade.model_calls
    if fast_steps:
        assert calls["edgepos"] == calls["edgez"] == fast_steps
    else:
        assert calls["edgepos"] == jcfg.pos_pndm_calls + jcfg.ddpm_tail
        assert calls["edgez"] == 19  # 12 PRK calls + 7 PLMS calls of a 10-step plan
