"""Port: the length-routed attention kernels K3 (per-head set attention) and K2
(packed attention on long sets) against the JAX package, and the routing rule.

CPU, f32. The plain versions agree with the JAX oracles (``_xla_attention``,
``_packed_reference``) on every row and with the Pallas kernels in interpret
mode (``_forward``, ``_packed_flash_forward``) on every row that attends to a
real key, at 1e-5 (same math, summation order apart): the Pallas kernels pad
S to their block with masked zero rows, so a row whose keys are all masked
averages V over the padded length there, and over the S real keys in the
plain references and in the port. The route function is held against JAX's
own rule traced at the real sizes, and an encoder layer on the per-head route
against JAX's layer with ``attn_impl="pallas_interpret"`` at 1e-4. The CUDA
kernels are held against the plain versions on the card in
``test_torch_port_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brepgen_tpu.kernels import attention as ja
from brepgen_tpu.nn import transformer as jtrans
from brepgen_tpu_torch.kernels import LAUNCH_COUNTS
from brepgen_tpu_torch.kernels import attention as ta
from brepgen_tpu_torch.kernels.attention import (
    packed_attention_reference,
    packed_flash_attention,
    packed_flash_attention_reference,
)
from brepgen_tpu_torch.kernels.set_attention import set_attention, set_attention_reference
from brepgen_tpu_torch.nn import transformer as ttrans
from brepgen_tpu_torch.weights import load_flax_params

TOL = 1e-5


def _mask(B, S, rng):
    """Ragged key padding (True = pad): none, only slot 0 kept, every key
    masked, then random masks of growing density with slot 0 kept."""
    mask = rng.random((B, S)) < np.linspace(0.1, 0.9, B)[:, None]
    mask[:, 0] = False
    mask[0] = False
    mask[1, 1:] = True
    mask[2] = True
    return mask


def _heads(B, H, S, D, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, H, S, D)).astype(np.float32) for _ in range(3))
    return q, k, v, _mask(B, S, rng)


def _has_key(mask):
    return ~mask.all(axis=1)


@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("S", [37, 130])
def test_set_attention_reference_matches_jax(D, S):
    q, k, v, mask = _heads(5, 2, S, D, seed=S + D)
    got = set_attention_reference(*map(torch.from_numpy, (q, k, v, mask))).numpy()
    jq, jk, jv, jm = map(jnp.asarray, (q, k, v, mask))
    oracle = np.asarray(ja._xla_attention(jq, jk, jv, jm))
    np.testing.assert_allclose(got, oracle, atol=TOL, rtol=0)
    pallas = np.asarray(ja._forward(jq, jk, jv, jm, None, True))
    rows = _has_key(mask)
    np.testing.assert_allclose(got[rows], pallas[rows], atol=TOL, rtol=0)
    # the all-masked sample: the uniform mean of V over the S real keys
    np.testing.assert_allclose(got[2], np.broadcast_to(v[2].mean(1, keepdims=True), v[2].shape),
                               atol=TOL, rtol=0)


def test_set_attention_on_cpu_takes_plain_version_without_counting():
    q, k, v, mask = map(torch.from_numpy, _heads(3, 2, 20, 32, seed=1))
    before = LAUNCH_COUNTS["set_attention"]
    assert torch.equal(set_attention(q, k, v, mask), set_attention_reference(q, k, v, mask))
    assert torch.equal(set_attention(q, k, v), set_attention_reference(q, k, v))
    assert LAUNCH_COUNTS["set_attention"] == before


def _packed(B, S, W, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(B, S, 3 * W)).astype(np.float32), _mask(B, S, rng)


@pytest.mark.parametrize("W,H", [(64, 2), (128, 2)])
def test_packed_flash_matches_jax(W, H):
    qkv, mask = _packed(4, 300, W, seed=W)
    tq, tm = torch.from_numpy(qkv), torch.from_numpy(mask)
    before = LAUNCH_COUNTS["packed_flash_attention"]
    got = packed_flash_attention(tq, H, tm).numpy()  # the plain version on the CPU
    assert LAUNCH_COUNTS["packed_flash_attention"] == before
    chunked = packed_flash_attention_reference(tq, H, tm, block_k=64).numpy()
    jq, jm = jnp.asarray(qkv), jnp.asarray(mask)
    oracle = np.asarray(ja._packed_reference(jq, H, jm))
    pallas = np.asarray(ja._packed_flash_forward(jq, H, jm, 128, 128, True))
    rows = _has_key(mask)
    for out in (got, chunked):
        np.testing.assert_allclose(out, oracle, atol=TOL, rtol=0)
        np.testing.assert_allclose(out[rows], pallas[rows], atol=TOL, rtol=0)
        np.testing.assert_allclose(out[2], np.broadcast_to(qkv[2, :, 2 * W:].mean(0), (300, W)),
                                   atol=TOL, rtol=0)
    np.testing.assert_allclose(got, packed_attention_reference(tq, H, tm).numpy(), atol=TOL,
                               rtol=0)


def test_packed_flash_without_mask_matches_jax():
    qkv, _ = _packed(3, 70, 64, seed=9)
    got = packed_flash_attention_reference(torch.from_numpy(qkv), 2, None, block_k=32).numpy()
    np.testing.assert_allclose(got, np.asarray(ja._packed_reference(jnp.asarray(qkv), 2, None)),
                               atol=TOL, rtol=0)


def _jax_route(S, W, H, dtype, monkeypatch):
    """The entry JAX's attention layer takes at [1, S, W] in ``dtype``,
    traced abstractly with recorders in place of its kernels."""
    taken = []

    def packed(qkv, num_heads, mask, block_q, interpret):
        streams = ja._needs_kv_streaming(S, W, qkv.dtype.itemsize) and ja.pltpu is not None
        taken.append("packed_flash" if streams else "packed")
        return jnp.zeros(qkv.shape[:2] + (W,), qkv.dtype)

    def per_head(q, k, v, mask, block_q, interpret):
        taken.append("per_head")
        return jnp.zeros_like(q)

    monkeypatch.setattr(ja, "fused_set_attention_packed", packed)
    monkeypatch.setattr(ja, "fused_set_attention", per_head)
    layer = jtrans.MultiHeadSelfAttention(W, H, dtype, "pallas")
    x = jax.ShapeDtypeStruct((1, S, W), dtype)
    jax.eval_shape(lambda x: layer.init_with_output(jax.random.PRNGKey(0), x), x)
    (route,) = taken
    return route


@pytest.mark.parametrize("S,W,H,dtype,want", [
    (1800, 768, 12, "float32", "packed"),
    (4000, 768, 12, "float32", "per_head"),
    (4000, 768, 12, "bfloat16", "packed"),
    (4000, 256, 8, "float32", "packed"),
    (8400, 768, 12, "float32", "packed_flash"),
    (8400, 256, 8, "float32", "packed_flash"),
    (8400, 256, 8, "bfloat16", "packed"),
])
def test_route_matches_jax_rule(S, W, H, dtype, want, monkeypatch):
    assert _jax_route(S, W, H, jnp.dtype(dtype), monkeypatch) == want
    assert ttrans.attention_route(S, W, getattr(torch, dtype)) == want


def test_route_follows_the_resident_bytes_override(monkeypatch):
    monkeypatch.setattr(ta, "PACKED_RESIDENT_BYTES", 16 * 1024 * 1024)
    assert ttrans.attention_route(4000, 768, torch.float32) == "packed"
    monkeypatch.setattr(ta, "PACKED_RESIDENT_BYTES", 1024)
    assert ttrans.attention_route(40, 64, torch.float32) == "per_head"
    assert ttrans.attention_route(8193, 64, torch.float32) == "packed_flash"


@pytest.mark.parametrize("route", ["per_head", "packed_flash"])
def test_encoder_layer_on_routed_kernel_matches_jax(route, monkeypatch):
    # 1 KB of resident K/V sends S=40, W=64 (10 KB in f32) off the packed
    # kernel in both packages; the long-set limit moves to 32 tokens in the
    # port only, as JAX's streaming entry needs S > 8192 to be reached
    monkeypatch.setattr(ja, "PACKED_RESIDENT_BYTES", 1024)
    monkeypatch.setattr(ta, "PACKED_RESIDENT_BYTES", 1024)
    if route == "packed_flash":
        monkeypatch.setattr(ttrans, "LONG_SET_TOKENS", 32)
    calls = {"set_attention": 0, "packed_flash_attention": 0}

    def spy(name, fn):
        def wrapped(*args):
            calls[name] += 1
            return fn(*args)
        monkeypatch.setattr(ttrans, name, wrapped)

    spy("set_attention", ttrans.set_attention)
    spy("packed_flash_attention", ttrans.packed_flash_attention)
    B, S, W, H = 3, 40, 64, 2
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, S, W)).astype(np.float32)
    mask = _mask(B, S, rng)
    mask[2, :5] = False  # the JAX kernel averages all-masked rows over its padding
    impl = "pallas_interpret" if route == "per_head" else "xla"
    jm = jtrans.EncoderLayer(W, H, 96, 0.0, attn_impl=impl)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, S, W)))
    want = np.asarray(jm.apply(params, jnp.asarray(x), jnp.asarray(mask)))
    tm = load_flax_params(ttrans.EncoderLayer(W, H, 96, attn_impl="kernel"), params).eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    assert calls == {"set_attention": route == "per_head",
                     "packed_flash_attention": route == "packed_flash"}
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
