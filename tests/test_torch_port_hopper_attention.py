"""Port: the Hopper attention kernels on the card. K1 (``csrc/packed_attention.cu``)
writes its training residuals, each row's max m and 1/l and, in bf16, its
output in f32, without changing its output; K5 (``csrc/packed_attention_bwd.cu``)
forms P from them, in bf16 on wgmma with TMA, in f32 on mma.sync through
3xTF32; K3 (``csrc/set_attention.cu``) runs K1's wgmma + TMA body in bf16 on
tensor maps over the split heads. Each is held to its plain PyTorch version
at the shapes ``chip_smoke.py`` measures, at ragged S for both head widths,
and against reads past its own batch or head.

Marked ``cuda``: they skip without a card. This file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_port_hopper_attention.py
"""

import numpy as np
import pytest
import torch

from brepgen_tpu_torch.kernels import LAUNCH_COUNTS
from brepgen_tpu_torch.kernels.attention import (
    packed_attention,
    packed_attention_backward,
    packed_attention_backward_reference,
    packed_attention_reference,
    packed_attention_with_stats,
)
from brepgen_tpu_torch.kernels.set_attention import set_attention, set_attention_reference

# (B, S, W, H) as chip_smoke.py's K5_SHAPES and K3_SHAPES: the deepcad edgez
# training shape, a demo width, the longest set; the ABC edge stages
REL = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -8}
ABS = 1e-4
K5_SHAPES = ((128, 600, 768, 12), (64, 160, 256, 8), (4, 1500, 768, 12))
K3_SHAPES = ((16, 4000, 768, 12), (4, 4000, 256, 8))
TILE_EDGES = (1, 15, 16, 17, 63, 64, 65, 127, 129, 601)
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(cuda, B, S, W, dtype, seed):
    """qkv, dO and ragged masks (sample 1 attends to one key, sample 2 to
    none), made on the host from a seed."""
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.normal(size=(B, S, 3 * W)).astype(np.float32))
    dout = torch.from_numpy(rng.normal(size=(B, S, W)).astype(np.float32))
    mask = rng.random((B, S)) < np.linspace(0.1, 0.9, B)[:, None]
    mask[:, 0] = False
    mask[0] = False
    if B > 1:
        mask[1, 1:] = True
    if B > 2:
        mask[2] = True
    return (qkv.to(cuda, dtype), dout.to(cuda, dtype), torch.from_numpy(mask).to(cuda))


def _within(got, want, rel):
    return bool(((got.double() - want.double()).abs() <= rel * want.double().abs() + ABS).all())


def _hold_backward(got, qkv, dout, H, mask, rel):
    """dqkv per element against the plain version in f32 on the same
    (bf16-valued) inputs and against the sums in f64; where the plain
    version's own f32 sums leave the bar of the f64 sums (dV of a one-key
    sample of 1500 rows), against the f64 sums alone."""
    exact = packed_attention_backward_reference(qkv, dout, H, mask, sums_in_f64=True)
    plain = packed_attention_backward_reference(qkv.float(), dout.float(), H, mask).double()
    assert torch.isfinite(got).all()
    assert _within(got, exact, rel), (got.double() - exact).abs().max().item()
    if _within(plain, exact, rel):
        assert _within(got, plain, rel), (got.double() - plain).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("S", [65, 601])
def test_k1_statistics_match_the_plain_ones_on_card(cuda, dtype, D, S):
    H = 2
    qkv, _, mask = _inputs(cuda, 4, S, H * D, dtype, seed=S + D)
    before = LAUNCH_COUNTS["packed_attention"]
    out, o32, stats = packed_attention_with_stats(qkv, H, mask)
    assert LAUNCH_COUNTS["packed_attention"] == before + 1
    assert stats.shape == (4, H, S, 2) and o32.dtype == torch.float32
    want, m, inv_l = packed_attention_reference(qkv.float(), H, mask, with_stats=True)
    # m is a max of the same f32 logits; 1/l an online sum of exps
    assert _within(stats[..., 0], m, 1e-6)
    assert ((stats[..., 1] - inv_l).abs() <= 1e-5 * inv_l).all()
    assert (stats[2, ..., 0] == -1e9).all() and torch.allclose(
        stats[2, ..., 1], torch.full_like(stats[2, ..., 1], 1.0 / S), rtol=1e-5)
    assert _within(o32, want, REL[dtype])
    assert torch.equal(out, o32.to(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("D", [32, 64])
def test_k1_output_is_the_same_with_and_without_statistics_on_card(cuda, dtype, D):
    H = 12 if D == 64 else 8
    qkv, _, mask = _inputs(cuda, 8, 600, H * D, dtype, seed=D)
    with torch.no_grad():
        plain_call = packed_attention(qkv, H, mask)
    out, _, _ = packed_attention_with_stats(qkv, H, mask)
    assert torch.equal(plain_call, out)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("B,S,W,H", K5_SHAPES)
def test_k5_matches_plain_and_f64_sums_at_the_measured_shapes_on_card(cuda, dtype, B, S, W, H):
    qkv, dout, mask = _inputs(cuda, B, S, W, dtype, seed=B + S)
    _, o32, stats = packed_attention_with_stats(qkv, H, mask)
    before = dict(LAUNCH_COUNTS)
    got = packed_attention_backward(qkv, dout, H, mask, out=o32, stats=stats)
    assert LAUNCH_COUNTS["packed_attention_backward"] == before["packed_attention_backward"] + 1
    assert got.dtype == dtype
    del o32, stats
    _hold_backward(got, qkv, dout, H, mask, REL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("S", TILE_EDGES)
def test_k5_tile_edges_on_card(cuda, dtype, D, S):
    # query tiles of (a) and key tiles of (b) past S at every edge
    H = 2
    qkv, dout, mask = _inputs(cuda, 4, S, H * D, dtype, seed=11 * S + D)
    _, o32, stats = packed_attention_with_stats(qkv, H, mask)
    got = packed_attention_backward(qkv, dout, H, mask, out=o32, stats=stats)
    _hold_backward(got, qkv, dout, H, mask, REL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_k5_two_launches_are_bit_equal_on_card(cuda, dtype):
    qkv, dout, mask = _inputs(cuda, 16, 600, 768, dtype, seed=3)
    _, o32, stats = packed_attention_with_stats(qkv, 12, mask)
    first = packed_attention_backward(qkv, dout, 12, mask, out=o32, stats=stats)
    assert torch.equal(first, packed_attention_backward(qkv, dout, 12, mask, out=o32,
                                                        stats=stats))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("S", [65, 601])
def test_k5_reads_nothing_of_the_next_batch_on_card(cuda, dtype, D, S):
    # the last query and key tiles of batch 0 reach past S into batch 1's
    # rows: batch 0's gradient is bit-equal and finite whether batch 1 holds
    # values or NaN (its qkv, dO, f32 output and statistics alike)
    H = 2
    qkv, dout, mask = _inputs(cuda, 2, S, H * D, dtype, seed=S + 5 * D)
    _, o32, stats = packed_attention_with_stats(qkv, H, mask)
    first = packed_attention_backward(qkv, dout, H, mask, out=o32, stats=stats)
    for t in (qkv, dout, o32, stats):
        t[1] = float("nan")
    second = packed_attention_backward(qkv, dout, H, mask, out=o32, stats=stats)
    assert torch.isfinite(first[0]).all()
    assert torch.equal(first[0], second[0])


def _heads(qkv, H):
    B, S, W3 = qkv.shape
    return [a.reshape(B, S, H, W3 // 3 // H).transpose(1, 2).contiguous()
            for a in qkv.split(W3 // 3, dim=-1)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,W,H", K3_SHAPES)
def test_k3_bf16_matches_plain_at_the_measured_shapes_on_card(cuda, B, S, W, H):
    qkv, _, mask = _inputs(cuda, B, S, W, torch.bfloat16, seed=S + W)
    q, k, v = _heads(qkv, H)
    before = LAUNCH_COUNTS["set_attention"]
    got = set_attention(q, k, v, mask)
    assert LAUNCH_COUNTS["set_attention"] == before + 1
    want = set_attention_reference(q.float(), k.float(), v.float(), mask)
    assert _within(got.float(), want, REL[torch.bfloat16])
    assert (got.float() - want).abs().max().item() <= 2e-2
    uniform = v[2].float().mean(1, keepdim=True).expand(H, S, W // H)
    assert _within(got[2].float(), uniform, REL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("S", TILE_EDGES)
def test_k3_bf16_tile_edges_and_no_read_across_heads_on_card(cuda, D, S):
    # the last tiles of head (b, h) reach past S into the next head's rows:
    # head 0 is bit-equal and finite whether the other heads hold values or
    # NaN
    B, H = 4, 2
    qkv, _, mask = _inputs(cuda, B, S, H * D, torch.bfloat16, seed=13 * S + D)
    q, k, v = _heads(qkv, H)
    got = set_attention(q, k, v, mask)
    want = set_attention_reference(q.float(), k.float(), v.float(), mask)
    assert _within(got.float(), want, REL[torch.bfloat16])
    for t in (q, k, v):
        t[0, 1:] = float("nan")
        t[1:] = float("nan")
    again = set_attention(q, k, v, mask)
    assert torch.isfinite(got[0, 0]).all()
    assert torch.equal(got[0, 0], again[0, 0])
