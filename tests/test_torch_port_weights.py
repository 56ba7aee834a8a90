"""Port: the committed all160k packs load strictly and match JAX on one call.

The four stage packs and the two VAE packs of
``artifacts/demo_round5/all160k/ckpt_packed`` (the demo architecture: width
256, 8 heads, 6 layers; VAEs (32, 64, 128, 128) and (32, 64, 128)) go into the
port's modules through ``weights.load_flax_params`` with numpy only; one call
at a small token count agrees with the JAX package to 1e-4 (CPU, f32).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from brepgen_tpu.nn import EdgeVAE as JEdgeVAE
from brepgen_tpu.nn import SurfVAE as JSurfVAE
from brepgen_tpu.nn import denoiser as jden
from brepgen_tpu_torch.cli.build import ARCHS, arch_of_packs, build_denoiser, build_vae
from brepgen_tpu_torch.weights import flatten_params, load_flax_params, to_state_dict

PACKS = os.path.join(os.path.dirname(__file__), "..", "artifacts", "demo_round5", "all160k",
                     "ckpt_packed")
STREAMS = {
    "surfpos": (6,), "surfz": (48, 6), "edgepos": (6, 6, 48), "edgez": (12, 6, 6, 6, 48),
}


def _pack(name):
    return os.path.join(PACKS, name)


def _flax_tree(path):
    """{"params": nested} from a flat pack, as ``train/checkpoint.py:load_params`` builds it."""
    tree = {}
    for k, v in flatten_params(path).items():
        node = tree
        *mods, leaf = k.split("/")
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = jnp.asarray(v)
    return {"params": tree}


@pytest.mark.parametrize("stage", list(STREAMS))
def test_stage_pack_loads_and_matches_jax(stage):
    path = _pack(f"{stage}.npz")
    tm = load_flax_params(build_denoiser(stage, arch="demo"), path).eval()
    jm = getattr(jden, f"make_{stage}_net")(**ARCHS["demo"]["denoiser"])
    rng = np.random.default_rng(len(stage))
    B, S = 2, 10
    streams = [rng.normal(size=(B, S, d)).astype(np.float32) for d in STREAMS[stage]]
    t = np.array([3, 700], np.int32)
    mask = np.zeros((B, S), bool)
    mask[1, 6:] = True
    want = jm.apply(_flax_tree(path), tuple(map(jnp.asarray, streams)), jnp.asarray(t),
                    jnp.asarray(mask))
    with torch.no_grad():
        got = tm([torch.from_numpy(s) for s in streams], torch.from_numpy(t), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


@pytest.mark.parametrize("option", ["surface", "edge"])
def test_vae_pack_loads_and_decodes_like_jax(option):
    path = _pack("surf_vae.npz" if option == "surface" else "edge_vae.npz")
    tm = load_flax_params(build_vae(option, arch="demo"), path).eval()
    jcls = JSurfVAE if option == "surface" else JEdgeVAE
    jm = jcls(block_out_channels=ARCHS["demo"][option])
    shape = (3, 4, 4, 3) if option == "surface" else (3, 4, 3)
    z = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    want = jax.jit(lambda p, z: jm.apply(p, z, method=jcls.decode))(_flax_tree(path), z)
    with torch.no_grad():
        got = tm.decode(torch.from_numpy(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_every_pack_key_is_consumed():
    for name in ("surfpos", "surfz", "edgepos", "edgez", "surf_vae", "edge_vae"):
        keys = set(to_state_dict(_pack(f"{name}.npz")))
        module = (build_vae({"surf_vae": "surface", "edge_vae": "edge"}[name], arch="demo")
                  if name.endswith("vae") else build_denoiser(name, arch="demo"))
        assert keys == set(module.state_dict()), name


def test_layout_rules():
    flat = {
        "params/d/kernel": np.arange(6, dtype=np.float32).reshape(2, 3),
        "params/c1/kernel": np.zeros((5, 2, 4), np.float32),
        "params/c2/kernel": np.zeros((3, 3, 2, 4), np.float32),
        "params/n/scale": np.ones(4, np.float32),
        "params/e/embedding": np.zeros((11, 4), np.float32),
        "params/d/bias": np.zeros(3, np.float32),
    }
    sd = to_state_dict(flat)
    assert torch.equal(sd["d.weight"], torch.arange(6.0).reshape(2, 3).T)
    assert sd["c1.weight"].shape == (4, 2, 5)
    assert sd["c2.weight"].shape == (4, 2, 3, 3)
    assert set(sd) == {"d.weight", "d.bias", "c1.weight", "c2.weight", "n.weight", "e.weight"}


def _tiny():
    m = nn.Module()
    m.fc = nn.Linear(2, 3)
    return m


def test_strict_loading_raises():
    good = {"fc": {"kernel": np.zeros((2, 3), np.float32), "bias": np.zeros(3, np.float32)}}
    load_flax_params(_tiny(), {"params": good})
    with pytest.raises(KeyError, match="missing"):
        load_flax_params(_tiny(), {"params": {"fc": {"kernel": good["fc"]["kernel"]}}})
    with pytest.raises(KeyError, match="unexpected"):
        load_flax_params(_tiny(), {"params": {**good, "extra": {"bias": np.zeros(1)}}})
    with pytest.raises(ValueError, match="shape"):
        load_flax_params(_tiny(), {"fc": {"kernel": np.zeros((3, 3)), "bias": np.zeros(3)}})


def test_arch_is_read_from_the_packs(tmp_path):
    assert arch_of_packs(PACKS) == "demo"
    qkv = "params/encoder/layer_0/attn/qkv/kernel"
    np.savez(tmp_path / "edgepos.npz", **{qkv: np.zeros((768, 3 * 768), np.float32)})
    assert arch_of_packs(str(tmp_path)) == "production"
    np.savez(tmp_path / "edgepos.npz", **{qkv: np.zeros((96, 3 * 96), np.float32)})
    with pytest.raises(ValueError, match="width 96"):
        arch_of_packs(str(tmp_path))
