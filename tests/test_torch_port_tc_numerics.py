"""Port: the rounding scheme of the tensor-core attention kernels (K3's
``csrc/set_attention.cu``, K1/K2's ``csrc/packed_attention.cu`` and K5's
``csrc/packed_attention_bwd.cu``, the scheme of ``csrc/mma_tile.cuh``),
emulated in plain PyTorch on the CPU and held to the f32 plain versions
under the per-element bars of ``chip_smoke.py``: |err| <= REL * |plain| + ABS.
K1/K2 in f32 run K3's forward itself on the packed layout; in bf16 they run
on wgmma instead of mma.sync with the same scheme (64-key tiles, products of
bf16 inputs exact, P split into a bf16 pair, each tile's P V, lo then hi,
into fresh accumulators), so the forward cases hold for them too; their exp
is ex2.approx (2^-22 relative, not emulated: far below the bf16 bar).

f32 inputs go through 3xTF32: each operand x is split into hi = tf32(x)
(round to nearest, ties away, to 10 mantissa bits: the low 13 bits masked)
and lo = x - hi, of which the tensor cores read the top 19 bits (the low 13
masked, truncated); a product sums lo*hi + hi*lo + hi*hi. bf16 inputs are
exact in the products; P and dS, formed in f32, are split into a bf16 pair
hi + lo. The kernels' tiles are emulated where they change the result: the
forward's online softmax over 64-key tiles, and Delta = rowsum(dO o O) from
the forward's output in f32 (a bf16 O would move it too far; K5 takes K1's
unrounded f32 output in bf16 too, whose scheme
``tests/test_torch_port_attention_stats.py`` emulates; ``emulate_backward``
below takes Delta = rowsum(dP o P) in bf16, the other way to the bar). Not emulated: the order of the f32 sums, and the
truncation of the tensor cores' own accumulation, which the kernels bound by
adding each step of a long sum into its accumulator with one rounding to
nearest; the card tests hold the kernels themselves to the same bars.
"""

import math
import sys

import numpy as np
import pytest
import torch

from brepgen_tpu_torch.kernels.attention import NEG_INF, packed_attention_backward_reference
from brepgen_tpu_torch.kernels.set_attention import set_attention_reference

REL = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -8}
ABS = 1e-4
TILE = 64


def tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: round the f32 mantissa to 10 bits, ties away from 0."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def truncate_tf32(x: torch.Tensor) -> torch.Tensor:
    """An f32 operand as the tf32 tensor cores read it: the low 13 bits dropped."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor, dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """x = hi + lo: tf32 halves for f32, bf16 halves for bf16."""
    if dtype == torch.float32:
        hi = tf32(x)
        return hi, truncate_tf32(x - hi)
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def mm(a: torch.Tensor, b: torch.Tensor, dtype, formed: bool = False,
       tf32_only: bool = False) -> torch.Tensor:
    """a @ b as the kernels take it. ``formed``: a is P or dS, made in the
    kernel (split in bf16 too); the inputs of a bf16 call are exact."""
    if dtype == torch.float32:
        (ah, al), (bh, bl) = split(a, dtype), split(b, dtype)
        if tf32_only:
            return ah @ bh
        return al @ bh + ah @ bl + ah @ bh
    if formed:
        ah, al = split(a, dtype)
        return al @ b + ah @ b
    return a @ b


def logits(q, k, bias, dtype, **kw):
    scale = torch.tensor(1.0 / math.sqrt(q.shape[-1]), dtype=torch.float32)
    return mm(q, k.transpose(-1, -2), dtype, **kw) * scale + bias


def emulate_forward(q, k, v, mask, dtype, **kw):
    """K3: online softmax over 64-key tiles, P through its split."""
    B, H, S, D = q.shape
    bias = torch.where(mask, NEG_INF, 0.0).float()[:, None, None, :]
    m = torch.full((B, H, S, 1), -1e30)
    l = torch.zeros((B, H, S, 1))
    o = torch.zeros((B, H, S, D))
    for k0 in range(0, S, TILE):
        s = logits(q, k[:, :, k0:k0 + TILE], bias[..., k0:k0 + TILE], dtype, **kw)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        o = o * corr + mm(p, v[:, :, k0:k0 + TILE], dtype, formed=True, **kw)
        m = m_new
    return (o / l).to(dtype).float()


def emulate_backward(qkv, dout, fwd, H, mask, dtype, delta_from_output=None):
    """K5 given the forward's output: P from the row statistics, Delta from
    dO o O in f32 and from dP o P in bf16, the three products with a formed
    operand through its split."""
    B, S, W3 = qkv.shape
    W = W3 // 3
    D = W // H
    heads = lambda a: a.reshape(B, S, H, D).transpose(1, 2).float()  # noqa: E731
    q, k, v = (heads(a) for a in qkv.split(W, dim=-1))
    g, o = heads(dout), heads(fwd)
    bias = torch.where(mask, NEG_INF, 0.0).float()[:, None, None, :]
    s = logits(q, k, bias, dtype)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m) * (1.0 / torch.exp(s - m).sum(-1, keepdim=True))
    dp = mm(g, v.transpose(-1, -2), dtype)
    if delta_from_output is None:
        delta_from_output = dtype == torch.float32
    delta = (g * o if delta_from_output else dp * p).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    scale = 1.0 / math.sqrt(D)
    dq = mm(ds, k, dtype, formed=True) * scale
    dk = mm(ds.transpose(-1, -2), q, dtype, formed=True) * scale
    dv = mm(p.transpose(-1, -2), g, dtype, formed=True)
    merge = lambda a: a.transpose(1, 2).reshape(B, S, W)  # noqa: E731
    return torch.cat([merge(dq), merge(dk), merge(dv)], dim=-1).to(dtype).float()


def _inputs(B, S, W, seed, dtype):
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.normal(size=(B, S, 3 * W)).astype(np.float32)).to(dtype)
    dout = torch.from_numpy(rng.normal(size=(B, S, W)).astype(np.float32)).to(dtype)
    mask = rng.random((B, S)) < np.linspace(0.1, 0.9, B)[:, None]
    mask[:, 0] = False
    mask[0] = False
    mask[1, 1:] = True  # one key
    mask[2] = True      # no key: uniform over the S real keys
    return qkv, dout, torch.from_numpy(mask)


def _over_bar(got, want, dtype):
    return ((got - want).abs() - (REL[dtype] * want.abs() + ABS)).max().item()


SHAPES = [(4, 600, 128, 2), (4, 129, 64, 2), (4, 17, 128, 2)]
DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("B,S,W,H", SHAPES)
def test_forward_scheme_within_the_bar(dtype, B, S, W, H):
    qkv, _, mask = _inputs(B, S, W, seed=S + W, dtype=dtype)
    q, k, v = (a.reshape(B, S, H, W // H).transpose(1, 2).float()
               for a in qkv.split(W, dim=-1))
    got = emulate_forward(q, k, v, mask, dtype)
    want = set_attention_reference(q, k, v, mask)
    assert _over_bar(got, want, dtype) <= 0
    uniform = v[2].mean(1, keepdim=True).expand_as(got[2])
    assert _over_bar(got[2], uniform, dtype) <= 0


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("B,S,W,H", SHAPES)
def test_backward_scheme_within_the_bar(dtype, B, S, W, H):
    qkv, dout, mask = _inputs(B, S, W, seed=S + 2 * W, dtype=dtype)
    want = packed_attention_backward_reference(qkv.float(), dout.float(), H, mask)
    # the forward's output as K1 hands it over: f32 sums, rounded to the type
    q, k, v = (a.reshape(B, S, H, W // H).transpose(1, 2).float()
               for a in qkv.split(W, dim=-1))
    fwd = set_attention_reference(q, k, v, mask).transpose(1, 2).reshape(B, S, W).to(dtype)
    got = emulate_backward(qkv.float(), dout.float(), fwd.float(), H, mask, dtype)
    assert torch.isfinite(got).all()
    assert _over_bar(got, want, dtype) <= 0


def test_bf16_delta_from_the_rounded_output_exceeds_the_bar():
    # why K5 in bf16 does not take Delta from the forward's bf16 output
    # (it takes K1's f32 output): from the output rounded to bf16, dQ and dK
    # move past the bar
    B, S, W, H = SHAPES[0]
    dtype = torch.bfloat16
    qkv, dout, mask = _inputs(B, S, W, seed=S + 2 * W, dtype=dtype)
    want = packed_attention_backward_reference(qkv.float(), dout.float(), H, mask)
    q, k, v = (a.reshape(B, S, H, W // H).transpose(1, 2).float()
               for a in qkv.split(W, dim=-1))
    fwd = set_attention_reference(q, k, v, mask).transpose(1, 2).reshape(B, S, W).to(dtype)
    got = emulate_backward(qkv.float(), dout.float(), fwd.float(), H, mask, dtype,
                           delta_from_output=True)
    assert _over_bar(got, want, dtype) > 0


def test_tf32_alone_fails_where_3xtf32_holds():
    # logits near 30: one TF32 rounding moves a logit by about 30 * 2^-11
    rng = np.random.default_rng(3)
    B, H, S, D = 2, 2, 129, 64
    q = rng.normal(size=(B, H, S, D))
    q = q / np.linalg.norm(q, axis=-1, keepdims=True) * math.sqrt(30 * math.sqrt(D))
    k = q + 0.1 * rng.normal(size=q.shape)
    q, k = (torch.from_numpy(a.astype(np.float32)) for a in (q, k))
    v = torch.from_numpy(rng.normal(size=(B, H, S, D)).astype(np.float32))
    mask = torch.zeros((B, S), dtype=torch.bool)
    assert (torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(D)).max() > 28
    want = set_attention_reference(q, k, v, mask)
    assert _over_bar(emulate_forward(q, k, v, mask, torch.float32), want, torch.float32) <= 0
    assert _over_bar(emulate_forward(q, k, v, mask, torch.float32, tf32_only=True), want,
                     torch.float32) > 0


def test_tf32_rounding_matches_cvt_rna():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11, -(1.0 + 2 ** -11),
                      1.0 + 2 ** -11 - 2 ** -23, 3.0e-39], dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -9, -(1.0 + 2 ** -10), 1.0,
                         tf32(torch.tensor([3.0e-39])).item()], dtype=torch.float32)
    assert torch.equal(tf32(x), want)
    hi, lo = split(x[:5], torch.float32)
    assert torch.equal(hi, tf32(x[:5])) and torch.equal(lo, truncate_tf32(x[:5] - hi))
    assert ((hi + lo - x[:5]).abs() <= 2.0 ** -21 * x[:5].abs()).all()


@pytest.mark.parametrize("part", ["forward", "backward"])
def test_one_bf16_rounding_of_p_and_ds_exceeds_the_bar(part, monkeypatch):
    # why the kernels split P and dS into a bf16 pair: rounded once, as
    # FlashAttention rounds them, they miss the per-element bar
    monkeypatch.setattr(sys.modules[__name__], "split", lambda x, dtype: (
        x.bfloat16().float(), torch.zeros_like(x)))
    B, S, W, H = SHAPES[1]
    dtype = torch.bfloat16
    qkv, dout, mask = _inputs(B, S, W, seed=S + W, dtype=dtype)
    q, k, v = (a.reshape(B, S, H, W // H).transpose(1, 2).float()
               for a in qkv.split(W, dim=-1))
    if part == "forward":
        got, want = emulate_forward(q, k, v, mask, dtype), set_attention_reference(q, k, v, mask)
    else:
        want = packed_attention_backward_reference(qkv.float(), dout.float(), H, mask)
        fwd = set_attention_reference(q, k, v, mask).transpose(1, 2).reshape(B, S, W)
        got = emulate_backward(qkv.float(), dout.float(), fwd, H, mask, dtype)
    assert _over_bar(got, want, dtype) > 0
