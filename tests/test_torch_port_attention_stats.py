"""Port: K1's training residuals and K5's scheme built on them, against the
JAX package on the CPU.

Under autograd K1 (``csrc/packed_attention.cu``) writes each row's max logit
m and 1/l = 1/sum_j exp(l_ij - m) beside its output, and in bf16 its output
in f32; K5 (``csrc/packed_attention_bwd.cu``) forms P = exp(l - m) * (1/l)
from them instead of recomputing the softmax, and Delta = rowsum(dO o O)
from the f32 output. Held here: the plain version's ``(out, m, 1/l)``
against m and l formed in JAX from the same logits as ``_packed_reference``
forms them; the gradients of ``PackedAttentionFn`` on the CPU (through the
saved statistics) against ``jax.vjp`` of ``fused_set_attention_packed`` in
interpret mode; and an emulation of K5's rounding scheme on those residuals
(the forward's online statistics over 64-key tiles, the f32 output, P and
dS split into a bf16 hi + lo pair, or 3xTF32 in f32) under
``chip_smoke.py``'s per-element bar, |err| <= REL * |plain| + ABS.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brepgen_tpu.kernels import attention as jattn
from brepgen_tpu_torch.kernels import attention as kattn

REL = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -8}
ABS = 1e-4
TILE = 64
TOL = 1e-4


def _inputs(B, S, W, seed, all_masked=True):
    """numpy qkv, dO and masks: sample 1 attends to one key, sample 2 (with
    ``all_masked``) to none, the last has a padded tail."""
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(B, S, 3 * W)).astype(np.float32)
    dout = rng.normal(size=(B, S, W)).astype(np.float32)
    mask = rng.random((B, S)) < np.linspace(0.1, 0.6, B)[:, None]
    mask[:, 0] = False
    mask[0] = False
    mask[1, 1:] = True
    if all_masked:
        mask[2] = True
    mask[-1, S - 5:] = True
    return qkv, dout, mask


def _jax_stats(qkv, H, mask):
    """m and l of each (batch, head, row) in JAX, the logits formed as
    ``_packed_reference`` -> ``_xla_attention`` forms them (f32 inputs)."""
    B, S, W3 = qkv.shape
    W = W3 // 3
    split = lambda a: a.reshape(B, S, H, W // H).transpose(0, 2, 1, 3)  # noqa: E731
    q, k, _ = (split(a) for a in jnp.split(jnp.asarray(qkv), 3, axis=-1))
    scale = 1.0 / jnp.sqrt(jnp.asarray(q.shape[-1], q.dtype))
    logits = jnp.einsum("bhqd,bhkd->bhqk", q, k) * scale
    logits = logits + jnp.where(jnp.asarray(mask)[:, None, None, :], jattn.NEG_INF,
                                0.0).astype(logits.dtype)
    m = logits.max(-1)
    return np.asarray(m), np.asarray(jnp.exp(logits - m[..., None]).sum(-1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("S,W,H", [(37, 64, 2), (70, 128, 2), (129, 256, 8)])
def test_plain_statistics_match_jax(dtype, S, W, H):
    qkv, _, mask = _inputs(4, S, W, seed=S + W)
    x = torch.from_numpy(qkv).to(dtype)
    out, m, inv_l = kattn.packed_attention_reference(x, H, torch.from_numpy(mask),
                                                     with_stats=True)
    assert m.dtype == inv_l.dtype == torch.float32 and m.shape == (4, H, S)
    # the kernel's logits are f32 sums of the (bf16-valued) inputs
    want_m, want_l = _jax_stats(x.float().numpy(), H, mask)
    np.testing.assert_allclose(m.numpy(), want_m, rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(inv_l.numpy(), 1.0 / want_l, rtol=1e-5)
    # the fully masked row: m = -1e9 and l = S (uniform P), kept apart
    assert (m[2] == -1e9).all()
    np.testing.assert_allclose(inv_l[2].numpy(), 1.0 / S, rtol=1e-6)
    assert torch.equal(out, kattn.packed_attention_reference(x, H, torch.from_numpy(mask)))
    want = jattn._packed_reference(jnp.asarray(x.float().numpy()), H, jnp.asarray(mask))
    np.testing.assert_allclose(out.float().numpy(), np.asarray(want),
                               atol=TOL if dtype == torch.float32 else 2e-2)


@pytest.mark.parametrize("S,W,H", [(37, 64, 2), (70, 128, 4), (129, 256, 8)])
def test_backward_through_the_statistics_matches_the_softmax(S, W, H):
    qkv, dout, mask = _inputs(4, S, W, seed=2 * S + W)
    x, g, m = torch.from_numpy(qkv), torch.from_numpy(dout), torch.from_numpy(mask)
    _, o32, stats = kattn.packed_attention_with_stats(x, H, m)
    assert stats.shape == (4, H, S, 2) and torch.equal(o32, kattn.packed_attention_reference(
        x, H, m))
    got = kattn.packed_attention_backward(x, g, H, m, out=o32, stats=stats)
    want = kattn.packed_attention_backward_reference(x, g, H, m)
    assert float((got - want).abs().max()) <= 1e-5


@pytest.mark.parametrize("S,W,H", [(37, 64, 2), (70, 256, 8), (20, 128, 2)])
def test_autograd_function_gradients_match_jax_vjp(S, W, H):
    # the CPU route of PackedAttentionFn: the forward saves (o32, stats), the
    # backward forms P from them; held to jax.vjp of the Pallas entry in
    # interpret mode on samples with a real key (the Pallas forward pads S
    # with masked keys, so a row with none averages over the padded length
    # there), and on the all-masked sample to autograd of the plain forward
    qkv, dout, mask = _inputs(4, S, W, seed=3 * S + W)
    m, g = torch.from_numpy(mask), torch.from_numpy(dout)
    x = torch.from_numpy(qkv).requires_grad_()
    out = kattn.packed_attention(x, H, m)
    assert out.grad_fn is not None and type(out.grad_fn).__name__.startswith("PackedAttentionFn")
    (got,) = torch.autograd.grad(out, x, g)
    _, vjp = jax.vjp(lambda a: jattn.fused_set_attention_packed(a, H, jnp.asarray(mask), None,
                                                                True), jnp.asarray(qkv))
    (want,) = vjp(jnp.asarray(dout))
    keep = [0, 1, 3]
    np.testing.assert_allclose(got.numpy()[keep], np.asarray(want)[keep], atol=TOL)
    y = torch.from_numpy(qkv).requires_grad_()
    (plain,) = torch.autograd.grad(kattn.packed_attention_reference(y, H, m), y, g)
    assert float((got[2] - plain[2]).abs().max()) <= 1e-5


# ---- K5's rounding scheme on K1's residuals, emulated ------------------------------


def _tf32(x):
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x, dtype):
    """x = hi + lo: 3xTF32 halves (lo truncated as the tensor cores read it)
    in f32, a bf16 pair in bf16."""
    if dtype == torch.float32:
        hi = _tf32(x)
        return hi, ((x - hi).contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def _mm(a, b, dtype, formed=False):
    """a @ b as the kernels take it: 3xTF32 in f32; in bf16 the inputs are
    exact and a formed operand (P, dS) goes through its bf16 pair."""
    if dtype == torch.float32:
        (ah, al), (bh, bl) = _split(a, dtype), _split(b, dtype)
        return al @ bh + ah @ bl + ah @ bh
    if formed:
        ah, al = _split(a, dtype)
        return al @ b + ah @ b
    return a @ b


def _heads(a, B, S, H):
    return a.reshape(B, S, H, -1).transpose(1, 2).float()


def _emulate_forward(q, k, v, bias, dtype):
    """K1: online softmax over 64-key tiles; returns the f32 output (before
    its rounding), m and 1/l, the residuals it hands to K5."""
    B, H, S, D = q.shape
    scale = torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32)
    m = torch.full((B, H, S, 1), -1e30)
    l = torch.zeros((B, H, S, 1))
    o = torch.zeros((B, H, S, D))
    for k0 in range(0, S, TILE):
        s = _mm(q, k[:, :, k0:k0 + TILE].transpose(-1, -2), dtype) * scale + bias[..., k0:k0 + TILE]
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        o = o * corr + _mm(p, v[:, :, k0:k0 + TILE], dtype, formed=True)
        m = m_new
    return o / l, m, 1.0 / l


def _emulate_k5(qkv, dout, H, mask, dtype):
    """K5 on K1's residuals: P = exp(l - m) * (1/l), Delta = rowsum(dO o O)
    with O the f32 output, dS = P o (dP - Delta), the three products with a
    formed operand through its split; dqkv rounded to the type."""
    B, S, W3 = qkv.shape
    W = W3 // 3
    D = W // H
    q, k, v = (_heads(a, B, S, H) for a in qkv.float().split(W, dim=-1))
    g = _heads(dout.float(), B, S, H)
    bias = torch.where(mask, kattn.NEG_INF, 0.0).float()[:, None, None, :]
    o32, m, inv_l = _emulate_forward(q, k, v, bias, dtype)
    scale = torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32)
    s = _mm(q, k.transpose(-1, -2), dtype) * scale + bias
    p = torch.exp(s - m) * inv_l
    dp = _mm(g, v.transpose(-1, -2), dtype)
    delta = (g * o32).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    dq = _mm(ds, k, dtype, formed=True) * scale
    dk = _mm(ds.transpose(-1, -2), q, dtype, formed=True) * scale
    dv = _mm(p.transpose(-1, -2), g, dtype, formed=True)
    merge = lambda a: a.transpose(1, 2).reshape(B, S, W)  # noqa: E731
    return torch.cat([merge(dq), merge(dk), merge(dv)], dim=-1).to(dtype).float()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,S,W,H", [(4, 600, 128, 2), (4, 129, 64, 2), (4, 17, 128, 2)])
def test_k5_scheme_on_k1_residuals_within_the_bar(dtype, B, S, W, H):
    qkv, dout, mask = _inputs(B, S, W, seed=S + 5 * W)
    x = torch.from_numpy(qkv).to(dtype)
    g = torch.from_numpy(dout).to(dtype)
    m = torch.from_numpy(mask)
    got = _emulate_k5(x, g, H, m, dtype)
    want = kattn.packed_attention_backward_reference(x.float(), g.float(), H, m)
    assert torch.isfinite(got).all()
    over = ((got - want).abs() - (REL[dtype] * want.abs() + ABS)).max().item()
    assert over <= 0, over
