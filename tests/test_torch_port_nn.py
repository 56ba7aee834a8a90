"""Port: layers, transformer, denoisers and both VAEs against the JAX package.

Same seeded inputs and the same flax parameters (carried over with
``brepgen_tpu_torch.weights``) through both; CPU, f32, tolerance 1e-4. The
parity hazards each have a case: LayerNorm eps 1e-6, GroupNorm eps 1e-6 in
both VAEs and 1e-5 in the vae1d ResConv and self-attention, exact GELU,
nearest upsampling and reflect padding in the FIR resamplers.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brepgen_tpu.nn import denoiser as jden
from brepgen_tpu.nn import layers as jlayers
from brepgen_tpu.nn import transformer as jtrans
from brepgen_tpu.nn import vae1d as jvae1d
from brepgen_tpu.nn import vae2d as jvae2d
from brepgen_tpu_torch.nn import denoiser as tden
from brepgen_tpu_torch.nn import layers as tlayers
from brepgen_tpu_torch.nn import transformer as ttrans
from brepgen_tpu_torch.nn import vae1d as tvae1d
from brepgen_tpu_torch.nn import vae2d as tvae2d
from brepgen_tpu_torch.nn.layers import cast_compute
from brepgen_tpu_torch.cli.build import seed_weights
from brepgen_tpu_torch.weights import load_flax_params, to_flax_params

KEY = jax.random.PRNGKey(0)
TOL = 1e-4


def _port(module, params):
    return load_flax_params(module, params).eval()


def _init(jm, *args):
    """Jitted flax init (eager init compiles op by op and is slow)."""
    return jax.jit(jm.init)(KEY, *args)


def _apply(jm, params, *args, method=None):
    return jax.jit(lambda p, *a: jm.apply(p, *a, method=method))(params, *args)


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=0)


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


# --- layers ------------------------------------------------------------------

@pytest.mark.parametrize("dim", [32, 33])
def test_sincos_embedding(dim):
    t = np.array([0, 1, 17, 999], np.int32)
    _close(tlayers.sincos_embedding(_t(t), dim), jlayers.sincos_embedding(jnp.asarray(t), dim), 1e-5)


@pytest.mark.parametrize("scale", [1.0, 1e-3])
def test_mlp_embedder(scale):
    # scale 1e-3: features of variance ~1e-6, where LayerNorm's eps decides
    x = _rand(2, 5, 6, seed=1, scale=scale)
    jm = jlayers.MLPEmbedder(16, out_dim=7)
    params = _init(jm, jnp.zeros((1, 6)))
    tm = _port(tlayers.MLPEmbedder(6, 16, 7), params)
    _close(tm(_t(x)), _apply(jm, params, x))


def test_layernorm_eps_is_flax_default():
    assert tlayers.LayerNorm(8).eps == 1e-6
    x = _rand(3, 8, seed=2, scale=1e-3)
    ln = jax.numpy.asarray(x)
    import flax.linen as fnn
    want = fnn.LayerNorm().apply({"params": {"scale": jnp.ones(8), "bias": jnp.zeros(8)}}, ln)
    with torch.no_grad():
        _close(tlayers.LayerNorm(8)(_t(x)), want)


# --- transformer and denoisers -------------------------------------------------

@pytest.mark.parametrize("attn_impl", ["plain", "kernel"])
@pytest.mark.parametrize("masked", [False, True])
def test_transformer_encoder(attn_impl, masked):
    B, S, W = 2, 11, 64
    x = _rand(B, S, W, seed=3)
    mask = np.zeros((B, S), bool)
    if masked:
        mask[0, 7:] = True
        mask[1, 1:] = True
    jm = jtrans.TransformerEncoder(width=W, num_heads=2, ffn_width=96, num_layers=2)
    params = _init(jm, jnp.zeros((1, S, W)))
    tm = _port(ttrans.TransformerEncoder(W, 2, 96, 2, attn_impl), params)
    m = _t(mask) if masked else None
    with torch.no_grad():
        got = tm(_t(x), m)
    _close(got, _apply(jm, params, x, mask if masked else None))


SMALL = dict(width=32, num_heads=2, ffn_width=64, num_layers=2)
STREAMS = {
    "surfpos": (6,), "surfz": (48, 6), "edgepos": (6, 6, 48), "edgez": (12, 6, 6, 6, 48),
}


def _denoiser_pair(stage, use_cf):
    jm = getattr(jden, f"make_{stage}_net")(use_cf=use_cf, **SMALL)
    S = 7
    streams = tuple(jnp.zeros((1, S, d)) for d in STREAMS[stage])
    label = jnp.zeros((1, 1), jnp.int32) if use_cf else None
    params = _init(jm, streams, jnp.zeros((1,), jnp.int32), None, label)
    tm = _port(getattr(tden, f"make_{stage}_net")(use_cf=use_cf, **SMALL), params)
    return jm, params, tm


@pytest.mark.parametrize("use_cf", [False, True])
@pytest.mark.parametrize("stage", ["surfpos", "surfz", "edgepos", "edgez"])
def test_denoiser_call(stage, use_cf):
    jm, params, tm = _denoiser_pair(stage, use_cf)
    B, S = 3, 9
    streams = [_rand(B, S, d, seed=i) for i, d in enumerate(STREAMS[stage])]
    t = np.array([0, 421, 999], np.int32)
    mask = np.zeros((B, S), bool)
    mask[1, 5:] = True
    label = np.array([[0], [3], [6]], np.int32) if use_cf else None
    want = _apply(jm, params, tuple(streams), t, mask, label)
    with torch.no_grad():
        got = tm([_t(s) for s in streams], _t(t), _t(mask),
                 None if label is None else _t(label).long())
    assert got.dtype == torch.float32
    _close(got, want)


def test_denoiser_embed_then_denoise():
    jm, params, tm = _denoiser_pair("edgez", False)
    B, S = 2, 6
    names = ("edgez", "vertpos", "edgepos", "surfpos", "surfz")
    s = {n: _rand(B, S, d, seed=10 + i) for i, (n, d) in enumerate(zip(names, STREAMS["edgez"]))}
    noisy = {k: s[k] for k in names[:2]}
    cond = {k: s[k] for k in names[2:]}
    mask = np.zeros((B, S), bool)
    mask[0, 4:] = True
    c = _apply(jm, params, cond, method="embed_streams")
    want = _apply(jm, params, noisy, 37, c, mask, method="denoise")
    with torch.no_grad():
        tc = tm.embed_streams({k: _t(v) for k, v in cond.items()})
        got = tm.denoise({k: _t(v) for k, v in noisy.items()}, 37, tc, _t(mask))
    _close(got, want)


def test_denoiser_bf16_compute_stays_close_to_f32():
    _, params, tm = _denoiser_pair("surfz", False)
    streams = [_t(_rand(2, 5, d, seed=20 + i)) for i, d in enumerate(STREAMS["surfz"])]
    with torch.no_grad():
        want = tm(streams, 100)
        got = cast_compute(tm, torch.bfloat16)(streams, 100)
    assert got.dtype == torch.float32
    assert tm.encoder.layer_0.norm1.weight.dtype == torch.float32
    assert tm.encoder.layer_0.fc1.weight.dtype == torch.bfloat16
    # bf16 keeps ~3 significant digits; two layers of it stay within 5e-2
    assert (got - want).abs().max().item() < 5e-2


# --- VAE building blocks ---------------------------------------------------------

def _nhwc(x):
    return _t(x).permute(0, 3, 1, 2)


def _nlc(x):
    return _t(x).transpose(1, 2)


@pytest.mark.parametrize("cin,cout", [(16, 16), (16, 32)])
@pytest.mark.parametrize("scale", [1.0, 1e-3])
def test_resnet_block_2d(cin, cout, scale):
    x = _rand(2, 4, 4, cin, seed=4, scale=scale)
    jm = jvae2d.ResnetBlock2D(cout)
    params = _init(jm, jnp.zeros((1, 4, 4, cin)))
    tm = _port(tvae2d.ResnetBlock2D(cin, cout), params)
    assert tm.norm1.eps == 1e-6
    with torch.no_grad():
        _close(tm(_nhwc(x)).permute(0, 2, 3, 1), _apply(jm, params, x))


def test_attn_block_2d():
    x = _rand(2, 4, 4, 32, seed=5)
    jm = jvae2d.AttnBlock2D()
    params = _init(jm, jnp.zeros((1, 4, 4, 32)))
    tm = _port(tvae2d.AttnBlock2D(32), params)
    with torch.no_grad():
        _close(tm(_nhwc(x)).permute(0, 2, 3, 1), _apply(jm, params, x))


@pytest.mark.parametrize("block", ["up", "down"])
def test_resample_2d(block):
    # nearest x2 upsampling; asymmetric-padded stride-2 downsampling
    x = _rand(2, 4, 4, 8, seed=6)
    jm = jvae2d.Upsample2D(8) if block == "up" else jvae2d.Downsample2D(8)
    params = _init(jm, jnp.zeros((1, 4, 4, 8)))
    tm = _port(tvae2d.Upsample2D(8) if block == "up" else tvae2d.Downsample2D(8), params)
    with torch.no_grad():
        _close(tm(_nhwc(x)).permute(0, 2, 3, 1), _apply(jm, params, x))


@pytest.mark.parametrize("fn", ["fir_downsample_1d", "fir_upsample_1d"])
@pytest.mark.parametrize("L", [4, 8, 32])
def test_fir_resample_reflect_padding(fn, L):
    # a ramp makes zero padding and reflect padding differ at both ends
    x = (_rand(2, L, 5, seed=L) + np.linspace(-3, 3, L)[None, :, None]).astype(np.float32)
    want = getattr(jvae1d, fn)(jnp.asarray(x))
    got = getattr(tvae1d, fn)(_nlc(x)).transpose(1, 2)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("cin,cout", [(16, 16), (16, 32)])
@pytest.mark.parametrize("scale", [1.0, 1e-2])
def test_resconv_block_1d(cin, cout, scale):
    x = _rand(2, 8, cin, seed=7, scale=scale)
    jm = jvae1d.ResConvBlock1D(cout, cout)
    params = _init(jm, jnp.zeros((1, 8, cin)))
    tm = _port(tvae1d.ResConvBlock1D(cin, cout, cout), params)
    assert tm.norm1.eps == 1e-5 and tm.norm2.eps == 1e-5
    with torch.no_grad():
        _close(tm(_nlc(x)).transpose(1, 2), _apply(jm, params, x))


def test_resconv_uses_exact_gelu():
    x = torch.linspace(-3, 3, 61)
    assert torch.equal(tvae1d._gelu_f32(x, torch.float32), torch.nn.functional.gelu(x))
    assert not torch.equal(tvae1d._gelu_f32(x, torch.float32),
                           torch.nn.functional.gelu(x, approximate="tanh"))


@pytest.mark.parametrize("scale", [1.0, 1e-2])
def test_self_attention_1d(scale):
    x = _rand(2, 8, 64, seed=8, scale=scale)
    jm = jvae1d.SelfAttention1D(2)
    params = _init(jm, jnp.zeros((1, 8, 64)))
    tm = _port(tvae1d.SelfAttention1D(64, 2), params)
    assert tm.norm.eps == 1e-5
    with torch.no_grad():
        _close(tm(_nlc(x)).transpose(1, 2), _apply(jm, params, x))


# --- whole VAEs ------------------------------------------------------------------
# seeded port weights, handed to JAX with ``to_flax_params`` (a flax init of a
# whole VAE compiles for longer than the tests run)

@pytest.fixture(scope="module")
def surf_vae():
    ch = (8, 16, 16, 16)
    tm = seed_weights(tvae2d.SurfVAE(ch), torch.Generator().manual_seed(0)).eval()
    return jvae2d.SurfVAE(block_out_channels=ch), to_flax_params(tm), tm


@pytest.fixture(scope="module")
def edge_vae():
    ch = (8, 16, 32)
    tm = seed_weights(tvae1d.EdgeVAE(ch), torch.Generator().manual_seed(1)).eval()
    return jvae1d.EdgeVAE(block_out_channels=ch), to_flax_params(tm), tm


def test_flax_round_trip(surf_vae, edge_vae):
    for _, params, tm in (surf_vae, edge_vae):
        fresh = copy.deepcopy(tm)
        with torch.no_grad():
            for p in fresh.parameters():
                p.zero_()
        back = load_flax_params(fresh, params).state_dict()
        assert all(torch.equal(back[k], v) for k, v in tm.state_dict().items())


def _moments(m, x):
    return m.quant_conv(m.encoder(x))


def test_surf_vae_decode(surf_vae):
    jm, params, tm = surf_vae
    z = _rand(3, 4, 4, 3, seed=9)
    with torch.no_grad():
        got = tm.decode(_t(z))
    assert got.shape == (3, 32, 32, 3)
    want = jax.jit(lambda p, z: jm.apply(p, z, method=jvae2d.SurfVAE.decode))(params, z)
    _close(got, want)


def test_surf_vae_encode(surf_vae):
    jm, params, tm = surf_vae
    x = _rand(2, 32, 32, 3, seed=10)
    want = jax.jit(lambda p, x: jm.apply(p, x, method=_moments))(params, x)
    with torch.no_grad():
        _close(tm.encode_moments(_t(x)), want)


def test_edge_vae_decode(edge_vae):
    jm, params, tm = edge_vae
    z = _rand(5, 4, 3, seed=11)
    with torch.no_grad():
        got = tm.decode(_t(z))
    assert got.shape == (5, 32, 3)
    want = jax.jit(lambda p, z: jm.apply(p, z, method=jvae1d.EdgeVAE.decode))(params, z)
    _close(got, want)


def test_edge_vae_encode(edge_vae):
    jm, params, tm = edge_vae
    x = _rand(3, 32, 3, seed=12)
    want = jax.jit(lambda p, x: jm.apply(p, x, method=_moments))(params, x)
    with torch.no_grad():
        _close(tm.encode_moments(_t(x)), want)
