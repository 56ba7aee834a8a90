"""Port: the CUDA kernels (K1 packed attention, K2 its long-set entry, K3
per-head set attention, K4 Chamfer matrix, K5 the packed attention's
backward) against their plain versions, on the card. The tile-edge cases
(``TILE_EDGES``) run every tensor-core kernel at ragged S for both head
widths and input types: K1/K2 in bf16 on wgmma with TMA, with a swizzle of
its own per head width. The ``stage_graphs`` tests hold cascades whose
denoiser calls replay CUDA graphs (``sampling/aot.py``) to the same cascades
run eagerly on the same noise. ``test_step_ingestion_of_card_exports`` runs
legs (a)-(c) of ``chip_smoke.py``'s phase step on STEP files a cascade on
the card exports. The multi-GPU tests run ``ldm_main --dp`` under torchrun
at world size 1 over NCCL, and a split train step over two gloo ranks sharing
the card (``tests/torch_port_dist.py``). The ``d16`` tests hold every
attention kernel at head width 16 (the entry check's flagship and the CLIs'
``--small``) to its plain version: K1/K2/K3 and K5 at ragged S, at the
shapes ``chip_smoke.py`` measures, and against reads past their batch or
head.

Marked ``cuda``: they skip without a card. This file imports no JAX, so it
also runs on a machine without it (``--noconftest`` skips the JAX set-up of
``tests/conftest.py``):

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""

import json
import os

import numpy as np
import pytest
import torch

import test_torch_port_hopper_attention as hopper  # the card helpers; imports no JAX
from brepgen_tpu_torch.kernels import LAUNCH_COUNTS
from brepgen_tpu_torch.kernels.attention import (
    packed_attention,
    packed_attention_backward,
    packed_attention_backward_reference,
    packed_attention_reference,
    packed_attention_with_stats,
    packed_flash_attention,
    packed_flash_attention_reference,
)
from brepgen_tpu_torch.kernels.chamfer import chamfer_matrix, chamfer_matrix_reference
from brepgen_tpu_torch.kernels.set_attention import set_attention, set_attention_reference


def _inputs(B, S, W, seed):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(B, S, 3 * W)).astype(np.float32)
    mask = rng.random((B, S)) < np.linspace(0.1, 0.9, B)[:, None]
    mask[:, 0] = False
    mask[0] = False
    mask[1, 1:] = True  # only slot 0 unmasked
    if B > 2:
        mask[2] = True  # every key masked
    return qkv, mask


def _hold_backward(got, qkv, dout, H, mask, rel):
    """K5's dqkv per element, |err| <= rel * |want| + 1e-4, against the same
    function with its sums in f64 and against its plain version in f32 on
    the same (bf16-valued) inputs, unless that plain version itself lies
    outside the bar of the f64 sums. Returns whether the plain version was
    held to; the message gives both errors and the plain version's drift."""
    got = got.double()
    plain = packed_attention_backward_reference(qkv.float(), dout.float(), H, mask).double()
    exact = packed_attention_backward_reference(qkv, dout, H, mask, sums_in_f64=True)
    assert torch.isfinite(got).all()
    text = (f"against plain {(got - plain).abs().max():.3e}, against f64 "
            f"{(got - exact).abs().max():.3e}, plain against f64 "
            f"{(plain - exact).abs().max():.3e}")
    plain_ok = bool(((plain - exact).abs() <= rel * exact.abs() + 1e-4).all())
    for want in (plain, exact) if plain_ok else (exact,):
        assert ((got - want).abs() <= rel * want.abs() + 1e-4).all(), text
    return plain_ok


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 0.0), (torch.bfloat16, 2.0 ** -8)])
@pytest.mark.parametrize("S,W,H", [(1800, 768, 12), (1800, 256, 8), (65, 64, 2)])
def test_kernel_matches_plain_on_card(cuda, dtype, rel, S, W, H):
    # against the plain version in f32 on the same inputs: the kernel works in
    # f32 and rounds its output once to the input type
    qkv, mask = _inputs(4, S, W, seed=S)
    qkv = torch.from_numpy(qkv).to(cuda, dtype)
    mask = torch.from_numpy(mask).to(cuda)
    before = LAUNCH_COUNTS["packed_attention"]
    got = packed_attention(qkv, H, mask).float()
    want = packed_attention_reference(qkv.float(), H, mask)
    assert LAUNCH_COUNTS["packed_attention"] == before + 1
    assert ((got - want).abs() <= rel * want.abs() + 1e-4).all()


@pytest.mark.cuda
def test_kernel_rejects_unsupported_input(cuda):
    with pytest.raises(ValueError):
        packed_attention(torch.zeros((1, 8, 3 * 96), device=cuda), 2)  # D = 48
    with pytest.raises(TypeError):
        packed_attention(torch.zeros((1, 8, 3 * 64), device=cuda, dtype=torch.float16), 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 0.0), (torch.bfloat16, 2.0 ** -8)])
@pytest.mark.parametrize("S,D,H", [(4000, 64, 12), (4000, 32, 8), (1, 64, 2), (63, 32, 2),
                                   (65, 64, 2), (8193, 32, 1)])
def test_set_attention_matches_plain_on_card(cuda, dtype, rel, S, D, H):
    # K3 against its plain version in f32 on the same inputs; the batch holds
    # a sample with only slot 0 unmasked and one with every key masked
    B = 4
    qkv, mask = _inputs(B, S, H * D, seed=S + D)
    q, k, v = (torch.from_numpy(a).to(cuda, dtype).reshape(B, S, H, D).transpose(1, 2)
               .contiguous() for a in np.split(qkv, 3, axis=-1))
    mask = torch.from_numpy(mask).to(cuda)
    before = LAUNCH_COUNTS["set_attention"]
    got = set_attention(q, k, v, mask).float()
    want = set_attention_reference(q.float(), k.float(), v.float(), mask)
    assert LAUNCH_COUNTS["set_attention"] == before + 1
    assert ((got - want).abs() <= rel * want.abs() + 1e-4).all()
    uniform = v[2].float().mean(1, keepdim=True).expand(H, S, D)
    assert ((got[2] - uniform).abs() <= rel * uniform.abs() + 1e-4).all()


@pytest.mark.cuda
def test_set_attention_rejects_unsupported_input(cuda):
    z = lambda *shape, dtype=torch.float32: torch.zeros(shape, device=cuda, dtype=dtype)
    with pytest.raises(ValueError):
        set_attention(z(1, 2, 8, 48), z(1, 2, 8, 48), z(1, 2, 8, 48))  # D = 48
    with pytest.raises(TypeError):
        f16 = z(1, 2, 8, 64, dtype=torch.float16)
        set_attention(f16, f16, f16)
    with pytest.raises(TypeError):
        set_attention(z(1, 2, 8, 64), z(1, 2, 8, 64, dtype=torch.bfloat16), z(1, 2, 8, 64))
    with pytest.raises(ValueError):
        set_attention(z(1, 2, 8, 64), z(1, 2, 8, 64), z(1, 2, 8, 64),
                      torch.zeros((1, 9), dtype=torch.bool, device=cuda))  # mask [B, S+1]
    with pytest.raises(ValueError):
        set_attention(z(1, 2, 8, 64), z(1, 2, 8, 64), z(1, 2, 8, 64),
                      torch.zeros((1, 8), dtype=torch.uint8, device=cuda))  # not bool
    with pytest.raises(ValueError):
        x = z(1, 8, 2, 64).transpose(1, 2)  # not contiguous
        set_attention(x, x, x)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 0.0), (torch.bfloat16, 2.0 ** -8)])
@pytest.mark.parametrize("B,S,W,H", [(2, 8400, 768, 12), (4, 8400, 256, 8), (4, 8193, 64, 2),
                                     (4, 65, 64, 2)])
def test_packed_flash_matches_plain_on_card(cuda, dtype, rel, B, S, W, H):
    # K2 against its own plain version (K/V in 2048-key chunks) in f32
    qkv, mask = _inputs(B, S, W, seed=S + W)
    qkv = torch.from_numpy(qkv).to(cuda, dtype)
    mask = torch.from_numpy(mask).to(cuda)
    before = dict(LAUNCH_COUNTS)
    got = packed_flash_attention(qkv, H, mask).float()
    want = packed_flash_attention_reference(qkv.float(), H, mask)
    assert LAUNCH_COUNTS["packed_flash_attention"] == before["packed_flash_attention"] + 1
    assert LAUNCH_COUNTS["packed_attention"] == before["packed_attention"]
    assert ((got - want).abs() <= rel * want.abs() + 1e-4).all()
    if B > 2:
        uniform = qkv[2, :, 2 * W:].float().mean(0).expand(S, W)
        assert ((got[2] - uniform).abs() <= rel * uniform.abs() + 1e-4).all()


@pytest.mark.cuda
def test_packed_flash_rejects_unsupported_input(cuda):
    with pytest.raises(ValueError):
        packed_flash_attention(torch.zeros((1, 8, 3 * 48), device=cuda), 1)  # D = 48
    with pytest.raises(TypeError):
        packed_flash_attention(torch.zeros((1, 8, 3 * 64), device=cuda, dtype=torch.float16), 1)
    with pytest.raises(ValueError):
        packed_flash_attention(torch.zeros((2, 8, 3 * 64), device=cuda), 1,
                               torch.zeros((2, 7), dtype=torch.bool, device=cuda))


def _clouds(n, P, seed):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=(n, P, 3)).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("S,R,P", [(256, 256, 2000), (37, 13, 300), (1, 5, 1), (17, 1, 2049)])
def test_chamfer_matches_plain_on_card(cuda, S, R, P):
    # per element against the plain version on the card: the kernel fuses
    # multiply-adds and sums in another order, about 1e-7 relative
    x, y = _clouds(S, P, seed=S).to(cuda), _clouds(R, P, seed=R + 1).to(cuda)
    before = LAUNCH_COUNTS["chamfer"]
    got = chamfer_matrix(x, y)
    want = chamfer_matrix_reference(x, y)
    assert LAUNCH_COUNTS["chamfer"] == before + 1
    assert ((got - want).abs() <= 1e-5 * want.abs() + 1e-7).all()


@pytest.mark.cuda
def test_chamfer_padded_points_are_excluded_on_card(cuda):
    x, y = _clouds(9, 300, seed=1), _clouds(6, 300, seed=2)
    x[:, 257:] = 1e3   # padding the kernel must not read
    y[:, 257:] = float("nan")
    got = chamfer_matrix(x.to(cuda), y.to(cuda), n_pts=257).cpu()
    want = chamfer_matrix_reference(x[:, :257], y[:, :257])
    assert ((got - want).abs() <= 1e-5 * want.abs() + 1e-7).all()


@pytest.mark.cuda
def test_chamfer_of_a_cloud_with_itself_is_zero(cuda):
    x = _clouds(3, 500, seed=3).to(cuda)
    d = chamfer_matrix(x, x)
    assert torch.equal(torch.diagonal(d), torch.zeros(3, device=cuda))
    assert (d.fill_diagonal_(1.0) > 0).all()


def _hold_chamfer(x, y, n, cuda):
    """K4 on the card against its plain version on the first n points, at
    the bar of the tests above; the padding past n is NaN on both sides."""
    x, y = x.clone(), y.clone()
    x[:, n:] = float("nan")
    y[:, n:] = float("nan")
    before = LAUNCH_COUNTS["chamfer"]
    got = chamfer_matrix(x.to(cuda), y.to(cuda), n_pts=n)
    assert LAUNCH_COUNTS["chamfer"] == before + 1
    want = chamfer_matrix_reference(x[:, :n].to(cuda), y[:, :n].to(cuda))
    assert torch.isfinite(got).all()
    assert ((got - want).abs() <= 1e-5 * want.abs() + 1e-7).all()
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("S,R,P,n", [(3, 4, 1, 1), (3, 4, 9, 1), (4, 3, 40, 31), (3, 4, 40, 33),
                                     (5, 4, 300, 257), (3, 2, 2100, 2001), (2, 3, 2049, 2049),
                                     (1, 5, 70, 61), (17, 1, 130, 129)])
def test_chamfer_point_and_cloud_edges_on_card(cuda, S, R, P, n):
    # n against the kernel's groups of b-points and its 2048-point passes
    # over a; S x R of one row and of one column
    _hold_chamfer(_clouds(S, P, seed=n), _clouds(R, P, seed=n + 1), n, cuda)


@pytest.mark.cuda
def test_chamfer_at_its_largest_point_count_on_card(cuda):
    from brepgen_tpu_torch.kernels.chamfer import _library

    n = _library().chamfer_max_points()
    assert 2049 < n < 20000
    _hold_chamfer(_clouds(1, n + 3, seed=5), _clouds(2, n + 3, seed=6), n, cuda)
    with pytest.raises(ValueError, match="at most"):
        chamfer_matrix(torch.zeros((1, n + 1, 3), device=cuda),
                       torch.zeros((1, n + 1, 3), device=cuda))


@pytest.mark.cuda
def test_chamfer_two_launches_are_bit_equal_on_card(cuda):
    x, y = _clouds(37, 2000, seed=7).to(cuda), _clouds(13, 2000, seed=8).to(cuda)
    first = chamfer_matrix(x, y, n_pts=1999)
    assert torch.equal(first, chamfer_matrix(x, y, n_pts=1999))


def _box_surface_clouds(S, P, seed):
    """S clouds on box surfaces inside the unit cube, centred and scaled as
    the eval protocol's normalize_pc, and their twins: the same points with
    a jitter of 1e-4, shuffled (nearest distances about 1e-4)."""
    rng = np.random.default_rng(seed)
    clouds, twins = [], []
    for _ in range(S):
        lo = rng.uniform(0.0, 0.3, 3)
        size = rng.uniform(0.3, 0.7, 3)
        areas = np.tile([size[1] * size[2], size[0] * size[2], size[0] * size[1]], 2)
        face = rng.choice(6, size=P, p=areas / areas.sum())
        pts = lo + rng.random((P, 3)) * size
        axis = face % 3
        pts[np.arange(P), axis] = np.where(face < 3, lo[axis], lo[axis] + size[axis])
        pts -= pts.mean(0)
        pts /= np.abs(pts).max()
        clouds.append(pts)
        twins.append(pts[rng.permutation(P)] + rng.normal(scale=1e-4, size=(P, 3)))
    return (torch.from_numpy(np.stack(clouds).astype(np.float32)),
            torch.from_numpy(np.stack(twins).astype(np.float32)))


@pytest.mark.cuda
def test_chamfer_of_near_duplicate_unit_cube_clouds_on_card(cuda):
    x, y = _box_surface_clouds(24, 2000, seed=11)
    got = _hold_chamfer(x, y, 2000, cuda)
    twins = torch.diagonal(got)
    assert (twins > 0).all() and (twins < 2e-7).all()
    # the twin entries are about as small as the bar's absolute term, so
    # they are also held to f64 with a relative bar alone: the expansion
    # |x|^2 + |y|^2 - 2 x.y is about 20% off there, direct differences are not
    exact = []
    for a, b in zip(x.to(cuda, torch.float64), y.to(cuda, torch.float64)):
        d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
        exact.append(d2.amin(1).mean() + d2.amin(0).mean())
    exact = torch.stack(exact)
    assert ((twins.double() - exact).abs() <= 1e-5 * exact + 1e-12).all()


@pytest.mark.cuda
def test_chamfer_rejects_unsupported_input(cuda):
    x = torch.zeros((2, 8, 3), device=cuda)
    with pytest.raises(TypeError):
        chamfer_matrix(x.double(), x.double())
    with pytest.raises(ValueError):
        chamfer_matrix(x, x.cpu())
    with pytest.raises(ValueError):
        chamfer_matrix(x.transpose(0, 1), x.transpose(0, 1))
    with pytest.raises(ValueError):
        chamfer_matrix(torch.zeros((1, 20000, 3), device=cuda), torch.zeros((1, 20000, 3), device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 0.0), (torch.bfloat16, 2.0 ** -8)])
@pytest.mark.parametrize("S,W,H", [(600, 768, 12), (601, 256, 8), (1500, 768, 12),
                                   (601, 64, 2), (65, 64, 1)])
def test_packed_backward_matches_plain_on_card(cuda, dtype, rel, S, W, H):
    # K5 against its plain version in f32 on the same (bf16-valued) inputs,
    # and against the same function with its sums in f64: the kernel sums in
    # f32 on the tensor cores, in another order than the plain version, and
    # rounds its output once to the input type. Sample 1 attends to one key,
    # sample 2 to none (uniform P over S keys). At S = 1500 in f32 the plain
    # version's own sums over 1500 rows leave the bar of the f64 sums (dV of
    # the one-key sample is about 150), so K5 is held to the f64 sums there.
    B = 4
    qkv, mask = _inputs(B, S, W, seed=S + W)
    dout = np.random.default_rng(S).normal(size=(B, S, W)).astype(np.float32)
    qkv = torch.from_numpy(qkv).to(cuda, dtype)
    dout = torch.from_numpy(dout).to(cuda, dtype)
    mask = torch.from_numpy(mask).to(cuda)
    with torch.no_grad():
        _, out, stats = packed_attention_with_stats(qkv, H, mask)
    before = dict(LAUNCH_COUNTS)
    got = packed_attention_backward(qkv, dout, H, mask, out=out, stats=stats)
    assert LAUNCH_COUNTS["packed_attention_backward"] == before["packed_attention_backward"] + 1
    assert LAUNCH_COUNTS["packed_attention"] == before["packed_attention"]
    assert _hold_backward(got, qkv, dout, H, mask, rel) or S == 1500


@pytest.mark.cuda
def test_packed_attention_grad_runs_k1_then_k5_on_card(cuda):
    # the entry's autograd path: forward K1, backward K5, one launch each
    qkv, mask = _inputs(4, 300, 256, seed=7)
    qkv = torch.from_numpy(qkv).to(cuda).requires_grad_()
    mask = torch.from_numpy(mask).to(cuda)
    dout = torch.randn((4, 300, 256), device=cuda)
    before = dict(LAUNCH_COUNTS)
    out = packed_attention(qkv, 8, mask)
    (got,) = torch.autograd.grad(out, qkv, dout)
    assert LAUNCH_COUNTS["packed_attention"] == before["packed_attention"] + 1
    assert LAUNCH_COUNTS["packed_attention_backward"] == before["packed_attention_backward"] + 1
    want = packed_attention_backward_reference(qkv.detach(), dout, 8, mask)
    assert ((got - want).abs() <= 1e-4).all()


@pytest.mark.cuda
def test_set_attention_and_long_set_grads_on_card(cuda):
    # K3 and K2 forward on the card, backward recomputed through the plain
    # version: equal to autograd of the plain version
    B, S, H, D = 4, 70, 2, 32
    qkv, mask = _inputs(B, S, H * D, seed=11)
    qkv = torch.from_numpy(qkv).to(cuda)
    mask = torch.from_numpy(mask).to(cuda)
    dout = torch.randn((B, S, H * D), device=cuda)
    x = qkv.clone().requires_grad_()
    (want,) = torch.autograd.grad(packed_attention_reference(x, H, mask), x, dout)
    x = qkv.clone().requires_grad_()
    (got,) = torch.autograd.grad(packed_flash_attention(x, H, mask), x, dout)
    assert ((got - want).abs() <= 1e-4).all()
    q, k, v = (a.reshape(B, S, H, D).transpose(1, 2).contiguous().requires_grad_()
               for a in qkv.split(H * D, dim=-1))
    g = dout.reshape(B, S, H, D).transpose(1, 2)
    got = torch.autograd.grad(set_attention(q, k, v, mask), (q, k, v), g)
    want = torch.autograd.grad(set_attention_reference(q, k, v, mask), (q, k, v), g)
    for a, b in zip(got, want):
        assert ((a - b).abs() <= 1e-4).all()


@pytest.mark.cuda
def test_packed_backward_rejects_unsupported_input(cuda):
    qkv = torch.zeros((2, 8, 3 * 64), device=cuda)
    dout = torch.zeros((2, 8, 64), device=cuda)
    d48 = torch.zeros((2, 8, 48), device=cuda)
    st = torch.zeros((2, 1, 8, 2), device=cuda)
    with pytest.raises(ValueError):
        packed_attention_backward(torch.zeros((2, 8, 3 * 48), device=cuda), d48, 1,
                                  out=d48, stats=st)  # D = 48
    with pytest.raises(ValueError):
        packed_attention_backward(qkv, dout[:, :7], 1, out=dout, stats=st)  # dout [B, S-1, W]
    with pytest.raises(ValueError):
        packed_attention_backward(qkv, dout.bfloat16(), 1, out=dout, stats=st)  # mixed types
    with pytest.raises(ValueError):
        packed_attention_backward(qkv, dout.cpu(), 1, out=dout, stats=st)  # dout on another device
    with pytest.raises(ValueError):
        packed_attention_backward(qkv, torch.zeros((2, 64, 8), device=cuda).transpose(1, 2), 1,
                                  out=dout, stats=st)
    with pytest.raises(ValueError):
        packed_attention_backward(qkv, dout, 1, out=dout[:, :7], stats=st)  # out [B, S-1, W]
    with pytest.raises(ValueError):
        packed_attention_backward(qkv, dout, 1, out=dout.bfloat16(), stats=st)  # out not f32
    with pytest.raises(ValueError):
        packed_attention_backward(qkv, dout, 1, out=dout, stats=st[:, :, :7])  # stats [B, H, S-1]
    with pytest.raises(TypeError):
        packed_attention_backward(qkv.half(), dout.half(), 1, out=dout.half(), stats=st)
    with pytest.raises(ValueError):
        packed_attention_backward(qkv, dout, 1, torch.zeros((2, 7), dtype=torch.bool,
                                                           device=cuda), out=dout, stats=st)


@pytest.mark.cuda
def test_chamfer_refuses_a_gradient(cuda):
    x = torch.zeros((2, 8, 3), device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward only"):
        chamfer_matrix(x, x.detach())


TILE_EDGES = (1, 15, 16, 17, 63, 64, 65, 127, 129, 601)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 0.0), (torch.bfloat16, 2.0 ** -8)])
@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("S", TILE_EDGES)
def test_set_attention_tile_edges_on_card(cuda, dtype, rel, D, S):
    # K3's tensor-core tiles at ragged S: 16-row warp tiles, 64-key tiles
    B, H = 4, 2
    qkv, mask = _inputs(B, S, H * D, seed=3 * S + D)
    q, k, v = (torch.from_numpy(a).to(cuda, dtype).reshape(B, S, H, D).transpose(1, 2)
               .contiguous() for a in np.split(qkv, 3, axis=-1))
    mask = torch.from_numpy(mask).to(cuda)
    got = set_attention(q, k, v, mask).float()
    want = set_attention_reference(q.float(), k.float(), v.float(), mask)
    assert ((got - want).abs() <= rel * want.abs() + 1e-4).all()
    uniform = v[2].float().mean(1, keepdim=True).expand(H, S, D)
    assert ((got[2] - uniform).abs() <= rel * uniform.abs() + 1e-4).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 0.0), (torch.bfloat16, 2.0 ** -8)])
@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("S", TILE_EDGES)
def test_packed_backward_tile_edges_on_card(cuda, dtype, rel, D, S):
    # K5 at ragged S, given the forward's output as training gives it; sample
    # 1 attends to one key, sample 2 to none
    B, H = 4, 2
    qkv, mask = _inputs(B, S, H * D, seed=5 * S + D)
    dout = np.random.default_rng(S + D).normal(size=(B, S, H * D)).astype(np.float32)
    qkv = torch.from_numpy(qkv).to(cuda, dtype)
    dout = torch.from_numpy(dout).to(cuda, dtype)
    mask = torch.from_numpy(mask).to(cuda)
    with torch.no_grad():
        _, out, stats = packed_attention_with_stats(qkv, H, mask)
    got = packed_attention_backward(qkv, dout, H, mask, out=out, stats=stats)
    assert _hold_backward(got, qkv, dout, H, mask, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 0.0), (torch.bfloat16, 2.0 ** -8)])
@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("S", TILE_EDGES)
@pytest.mark.parametrize("entry", ["packed_attention", "packed_flash_attention"])
def test_packed_attention_tile_edges_on_card(cuda, entry, dtype, rel, D, S):
    # K1 and K2 (the same kernel through its long-set entry) at ragged S: f32
    # on 16-row warp tiles, bf16 on 64-row wgmma tiles, 64-key tiles in both,
    # TMA's zero fill past S (bf16) against the plain version in f32 on the
    # same (bf16-valued) inputs; sample 1 attends to one key, sample 2 to
    # none (the uniform mean of V)
    B, H = 4, 2
    fn, plain = {"packed_attention": (packed_attention, packed_attention_reference),
                 "packed_flash_attention": (packed_flash_attention,
                                            packed_flash_attention_reference)}[entry]
    qkv, mask = _inputs(B, S, H * D, seed=7 * S + D)
    qkv = torch.from_numpy(qkv).to(cuda, dtype)
    mask = torch.from_numpy(mask).to(cuda)
    before = LAUNCH_COUNTS[entry]
    got = fn(qkv, H, mask).float()
    assert LAUNCH_COUNTS[entry] == before + 1
    want = plain(qkv.float(), H, mask)
    assert ((got - want).abs() <= rel * want.abs() + 1e-4).all()
    uniform = qkv[2, :, 2 * H * D:].float().mean(0).expand(S, H * D)
    assert ((got[2] - uniform).abs() <= rel * uniform.abs() + 1e-4).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("S", [65, 601])
def test_packed_attention_reads_nothing_of_the_next_batch_on_card(cuda, dtype, D, S):
    # the last tiles of batch 0 reach past S into the rows where batch 1
    # begins: they must be read as zeros (bf16: the 3-D tensor map's fill),
    # so batch 0 comes out bit-equal and finite whether batch 1 holds random
    # values or NaN
    H = 2
    qkv, mask = _inputs(2, S, H * D, seed=S + 3 * D)
    qkv = torch.from_numpy(qkv).to(cuda, dtype)
    mask = torch.from_numpy(mask).to(cuda)
    first = packed_attention(qkv, H, mask)
    qkv[1] = float("nan")
    second = packed_attention(qkv, H, mask)
    assert torch.isfinite(first[0]).all()
    assert torch.equal(first[0], second[0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_backward_is_deterministic_on_card(cuda, dtype):
    # two launches, no atomics: the same dqkv to the bit
    qkv, mask = _inputs(8, 600, 768, seed=21)
    qkv = torch.from_numpy(qkv).to(cuda, dtype)
    mask = torch.from_numpy(mask).to(cuda)
    dout = torch.randn((8, 600, 768), device=cuda).to(dtype)
    with torch.no_grad():
        _, out, stats = packed_attention_with_stats(qkv, 12, mask)
    first = packed_attention_backward(qkv, dout, 12, mask, out=out, stats=stats)
    assert torch.equal(first, packed_attention_backward(qkv, dout, 12, mask, out=out, stats=stats))


def _large_logits(cuda, B, S, H, D, seed):
    # q, k rows of norm sqrt(30 sqrt(D)), k a small step from q: the diagonal
    # logits reach about 30, where one TF32 rounding of q or k moves a logit
    # by about 30 * 2^-11 and the softmax by 1.5% (tests/test_torch_port_tc_numerics.py)
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn((B, H, S, D), generator=gen, device=cuda)
    q = q / q.norm(dim=-1, keepdim=True) * (30 * D ** 0.5) ** 0.5
    k = q + 0.1 * torch.randn((B, H, S, D), generator=gen, device=cuda)
    v = torch.randn((B, H, S, D), generator=gen, device=cuda)
    assert (torch.einsum("bhqd,bhkd->bhqk", q, k) / D ** 0.5).max() > 28
    return q, k, v


@pytest.mark.cuda
def test_f32_logits_near_30_take_the_3xtf32_split_on_card(cuda):
    B, S, H, D = 2, 129, 2, 64
    q, k, v = _large_logits(cuda, B, S, H, D, seed=4)
    mask = torch.zeros((B, S), dtype=torch.bool, device=cuda)
    got = set_attention(q, k, v, mask)
    assert ((got - set_attention_reference(q, k, v, mask)).abs() <= 1e-4).all()
    qkv = torch.cat([a.transpose(1, 2).reshape(B, S, H * D) for a in (q, k, v)], -1)
    qkv = qkv.contiguous()
    got = packed_attention(qkv, H, mask)
    assert ((got - packed_attention_reference(qkv, H, mask)).abs() <= 1e-4).all()
    dout = torch.randn((B, S, H * D), device=cuda)
    with torch.no_grad():
        _, out, stats = packed_attention_with_stats(qkv, H, mask)
    got = packed_attention_backward(qkv, dout, H, mask, out=out, stats=stats)
    assert _hold_backward(got, qkv, dout, H, mask, 0.0)


@pytest.mark.cuda
def test_surface_vae_bf16_step_at_production_width_on_card(cuda):
    # the VAE CLI's step (train_vae.sh: --bf16, batch 512) on one batch of
    # synthetic surface grids at the production widths: finite, falling loss
    from brepgen_tpu_torch.cli import vae_main
    from brepgen_tpu_torch.cli.build import seed_weights
    from brepgen_tpu_torch.train import vae_train
    from brepgen_tpu_torch.train.common import TrainState, make_vae_optimizer

    args = vae_main.get_args(["--synthetic", "200", "--bf16"])
    grids = vae_main.load_train_array(args)
    batch = torch.from_numpy(np.resize(grids, (512,) + grids.shape[1:])).to(cuda)
    model = seed_weights(vae_main.build_model(args), torch.Generator().manual_seed(0)).to(cuda)
    state = TrainState(model, make_vae_optimizer(model.parameters()))
    step = vae_train.make_train_step(model, torch.bfloat16)
    gen = torch.Generator().manual_seed(1)
    losses = [float(step(state, batch, gen)["loss"]) for _ in range(5)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert all(p.dtype == torch.float32 for p in model.parameters())


def _graph_models(cuda, arch, dtype=torch.float32):
    """Seeded denoisers at ``arch`` (edge stages through the kernels) and
    small VAEs, on the card in ``dtype``."""
    from brepgen_tpu_torch import nn as tnn
    from brepgen_tpu_torch.cli.build import build_denoiser, seed_weights
    from brepgen_tpu_torch.nn.layers import cast_compute

    gen = torch.Generator().manual_seed(0)
    nets = {s: seed_weights(build_denoiser(s, arch="demo", **arch), gen).to(cuda).eval()
            for s in ("surfpos", "surfz", "edgepos", "edgez")}
    vaes = [seed_weights(m, gen).to(cuda).eval()
            for m in (tnn.SurfVAE((8, 8, 8, 8)), tnn.EdgeVAE((8, 8, 8)))]
    for m in (*nets.values(), *vaes):
        cast_compute(m, dtype)
    return nets, *vaes


def _eager_and_captured(cuda, models, cfg, batches=2, noise_of=None, between=None):
    """Each batch through an eager cascade and a captured one on the same
    noise (a generator seeded with the batch index, ``noise_of(batch,
    noise)`` wrapping it); ``between()`` runs between the captured batches.
    Returns the captured cascade, its graphs and per batch (eager outputs,
    captured outputs, eager K1 launches, captured K1 launches)."""
    from brepgen_tpu_torch.kernels import reset_launch_counts
    from brepgen_tpu_torch.sampling import Cascade, GeneratorNoise
    from brepgen_tpu_torch.sampling.aot import StageGraphs

    graphs = StageGraphs(None, cuda)
    eager, captured = Cascade(*models, cfg), Cascade(*models, cfg, graphs=graphs)
    runs = []
    for batch in range(batches):
        row = []
        for c in (eager, captured):
            noise = GeneratorNoise(torch.Generator(device=cuda).manual_seed(batch))
            if noise_of is not None:
                noise = noise_of(batch, noise)
            reset_launch_counts()
            row.append(c(noise))
            torch.cuda.synchronize()
            row.append(LAUNCH_COUNTS["packed_attention"])
        runs.append((row[0], row[2], row[1], row[3]))
        if between is not None:
            between()
    return captured, graphs, runs


def _assert_same(eager, captured, rel):
    """Captured outputs equal to eager: masks exactly, values within ``rel``
    of each output's largest magnitude (0: bit-equal)."""
    for k, want in eager.items():
        got = captured[k]
        assert got.shape == want.shape and got.dtype == want.dtype, k
        if want.dtype == torch.bool:
            assert torch.equal(got, want), k
        else:
            err = (got.float() - want.float()).abs().max().item()
            assert err <= rel * want.float().abs().max().item(), (k, err)


@pytest.mark.cuda
def test_stage_graphs_match_eager_on_card(cuda):
    # f32 through K1 (width 64, 2 heads: D=32), the PNDM + DDPM protocol cut
    # short; the same kernels in the same order, so bit-equal is expected and
    # 1e-6 of each output's largest value is the bar
    from brepgen_tpu_torch.sampling import CascadeConfig

    cfg = CascadeConfig(batch_size=2, num_surfaces=6, num_edges=5, pndm_steps=20,
                        pos_pndm_calls=16, ddpm_tail=10)
    models = _graph_models(cuda, dict(width=64, num_heads=2, ffn_width=128, num_layers=2))
    captured, graphs, runs = _eager_and_captured(cuda, models, cfg)
    for eager_out, captured_out, eager_k1, captured_k1 in runs:
        _assert_same(eager_out, captured_out, 1e-6)
        assert captured_k1 == eager_k1 > 0
    assert [e["stage"] for e in graphs.entries] == ["surfpos", "surfpos", "surfz", "edgepos",
                                                    "edgez"]
    assert all(e["kernel_nodes"] > 0 for e in graphs.entries)


@pytest.mark.cuda
def test_stage_graphs_capture_a_new_bucket_on_card(cuda):
    # compaction: batch 1's surfpos draws are zeros, so its face slots are
    # equal and dedup keeps one; the edge stages run on another bucket, a new
    # signature and a second pair of edge graphs, both equal to eager
    from brepgen_tpu_torch.sampling import CascadeConfig

    def zero_surfpos(batch, noise):
        if batch == 0:
            return noise
        return lambda site, shape, step=None: (
            torch.zeros(shape, device=cuda) if site.startswith("surfpos")
            else noise(site, shape, step))

    cfg = CascadeConfig(batch_size=2, num_surfaces=6, num_edges=5, fast_steps=6,
                        compact=True, compact_granularity=4)
    models = _graph_models(cuda, dict(width=64, num_heads=2, ffn_width=128, num_layers=2))
    captured, graphs, runs = _eager_and_captured(cuda, models, cfg, noise_of=zero_surfpos)
    for eager_out, captured_out, eager_k1, captured_k1 in runs:
        _assert_same(eager_out, captured_out, 1e-6)
        assert captured_k1 == eager_k1 > 0
    edge = [tuple(e["shapes"]["x"]) for e in graphs.entries if e["stage"] == "edgez"]
    assert len(edge) == 2 and edge[0] != edge[1], edge
    assert captured.last_bucket == 4


@pytest.mark.cuda
def test_stage_graphs_bf16_wgmma_replay_after_other_allocations_on_card(cuda):
    # bf16 edge stages run K1 on wgmma with TMA, whose tensor map (qkv's
    # address) is encoded at capture and frozen in the graph; between the
    # batches unrelated tensors are allocated and freed, so a replay reading
    # anything but the graph's own pool would differ from eager
    from brepgen_tpu_torch.sampling import CascadeConfig

    held = []

    def churn():
        for n in (1 << 20, 3 << 20, 1 << 24):
            held.append(torch.full((n,), float("nan"), device=cuda))
        del held[::2]

    cfg = CascadeConfig(batch_size=4, num_surfaces=10, num_edges=8, fast_steps=8)
    models = _graph_models(cuda, dict(width=256, num_heads=8, ffn_width=512, num_layers=2),
                           torch.bfloat16)
    _, _, runs = _eager_and_captured(cuda, models, cfg, batches=3, between=churn)
    for eager_out, captured_out, eager_k1, captured_k1 in runs:
        _assert_same(eager_out, captured_out, 0.0)
        assert captured_k1 == eager_k1 > 0


@pytest.mark.cuda
def test_stage_graphs_capture_after_a_cascades_graphs_are_gone_on_card(cuda):
    # resample_main --cf: one StageGraphs, a new cascade (and store of
    # graphs) per class; capturing into the shared pool after the first
    # store is dropped raised PyTorch's "use_count > 0" assert at class 2.
    # The stage holds a matmul, as every denoiser does; integer values keep
    # its products exact
    import gc

    from brepgen_tpu_torch.sampling.aot import StageGraphs

    graphs = StageGraphs(None, cuda)
    x = torch.arange(32, dtype=torch.float32, device=cuda).reshape(4, 8)
    w = (torch.arange(64, device=cuda).reshape(8, 8) % 5 - 2).float()
    for cls in range(3):
        captured = {}
        c = torch.full((1,), cls + 1.0, device=cuda)
        eps = graphs.stage("surfpos", lambda x, t, c: (x @ w) * c + t, (c,), captured,
                           torch.float32)
        for t in range(2):
            assert torch.equal(eps(x, t), (x @ w) * c + t)
        del captured, eps
        gc.collect()
    assert len(graphs.calls) == 3


@pytest.mark.cuda
def test_new_bucket_captured_beside_postprocess_threads_on_card(cuda, tmp_path, monkeypatch):
    # the sample CLI's path with --compact on the all160k packs: batch 1's
    # surfpos draws are zeros, so dedup keeps one face a sample and its edge
    # stages need another bucket, captured while the thread pool
    # post-processes batch 0 (re-decode and joint optimisation on the card);
    # batch 2 replays batch 0's graphs. Held to the same cascade run eagerly
    # on the same noise, postprocess on as well
    import threading

    from brepgen_tpu_torch.cli import sample_main
    from brepgen_tpu_torch.sampling import Cascade, GeneratorNoise, aot

    class ZeroBatch1(GeneratorNoise):
        batch = -1

        def __call__(self, site, shape, step=None):
            self.batch += site == "surfpos"
            if self.batch == 1 and site.startswith("surfpos"):
                return torch.zeros(tuple(shape), device=self.generator.device)
            return super().__call__(site, shape, step)

    busy, lock, captures = [0], threading.Lock(), []
    real_process, real_capture = sample_main.process_one, aot.StageGraphs._capture

    def process_one(*args, **kw):
        with lock:
            busy[0] += 1
        try:
            return real_process(*args, **kw)
        finally:
            with lock:
                busy[0] -= 1

    def capture(self, stage, *args, **kw):
        captures.append((stage, busy[0]))
        return real_capture(self, stage, *args, **kw)

    monkeypatch.setattr(sample_main, "process_one", process_one)
    monkeypatch.setattr(aot.StageGraphs, "_capture", capture)
    monkeypatch.setattr(sample_main, "GeneratorNoise", ZeroBatch1)
    captured = sample_main.init_cascade(
        "abc", os.path.join(os.path.dirname(__file__), "..", "artifacts", "demo_round5", "all160k",
                            "ckpt_packed"), batch_size=8, device="cuda",
        step_overrides=dict(fast_steps=10, compact=True, compact_granularity=4),
        aot_cache=str(tmp_path / "graphs"))
    eager = Cascade(captured.nets, captured.surf_vae, captured.edge_vae, captured.cfg)
    # two threads for eight samples: batch 0's postprocess outlasts batch 1's
    # surf stages
    runs = {name: sample_main.sample_loop(c, max_batches=3, seed=0, workers=2,
                                          save_folder=str(tmp_path / name))
            for name, c in (("eager", eager), ("captured", captured))}
    for b, (want, got) in enumerate(zip(runs["eager"].batches, runs["captured"].batches)):
        for k, v in want.items():
            assert np.array_equal(got[k], v), (b, k)
    assert runs["eager"].attempted == runs["captured"].attempted == 24
    edge = [tuple(e["shapes"]["x"]) for e in captured.graphs.entries if e["stage"] == "edgez"]
    assert edge[0][1] > edge[1][1] == 4 * 40, edge  # batch 1: 4 face slots
    # batch 1's edge stages were captured while samples were in postprocess
    assert [s for s, n in captures if n][:1] == ["edgepos"], captures
    with open(tmp_path / "graphs" / aot.MANIFEST) as f:
        assert len(json.load(f)) == len(captured.graphs.entries)


@pytest.mark.cuda
def test_step_ingestion_of_card_exports(cuda, tmp_path, monkeypatch):
    # legs (a)-(c) of chip_smoke.py's phase step at a small size: (a) the
    # STEP files a cascade on the card exports pass the port's conformance
    # validator, and validate_solid where they hold a solid; (b) synthetic
    # solids written as STEP; (c) extracted back by the shard driver in
    # process_main subprocesses, one pkl each, within 5e-2 of the source
    import pickle

    from brepgen_tpu_torch.cli import sample_main, shard_driver
    from brepgen_tpu_torch.cli.build import uid_to_path
    from brepgen_tpu_torch.data.synthetic import make_dataset
    from brepgen_tpu_torch.geometry import construct_brep, load_brep, validate_solid
    from brepgen_tpu_torch.geometry.step_conformance import validate_step_file

    root = os.path.join(os.path.dirname(__file__), "..")
    cascade = sample_main.init_cascade(
        "deepcad", os.path.join(root, "artifacts", "demo_round5", "all160k", "ckpt_packed"),
        batch_size=8, device="cuda")
    run = sample_main.sample_loop(cascade, max_batches=1, save_folder=str(tmp_path / "card"),
                                  workers=4)
    files = sorted(str(p) for p in (tmp_path / "card").glob("*.step"))
    assert len(files) == run.produced >= 1
    solids = 0
    for path in files:
        assert validate_step_file(path) == [], path
        if "MANIFOLD_SOLID_BREP" in open(path).read():
            assert validate_solid(load_brep(path))["ok"], path
            solids += 1
    assert solids == run.solid >= 1

    tree, sources = tmp_path / "steps", {}
    tree.mkdir()
    for i, data in enumerate(make_dataset(24, seed=0)):
        construct_brep(data["surf_wcs"], data["edge_wcs"], data["faceEdge_adj"],
                       data["edgeCorner_adj"]).write_step(str(tree / f"{i:08d}.step"))
        sources[f"{i:08d}.pkl"] = data["surf_wcs"]
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        p for p in (os.path.abspath(root), os.environ.get("PYTHONPATH")) if p))
    out = str(tmp_path / "parsed")
    manifest = shard_driver.process_shards_main(
        ["--input", str(tree), "--output", out, "--option", "furniture", "--shard_size", "8",
         "--timeout", "300", "--retries", "0"])
    assert manifest["done"] == [0, 1, 2] and manifest["failed"] == []
    pkls = sorted(p.name for p in (tmp_path / "parsed").rglob("*.pkl"))
    assert pkls == sorted(sources)
    for uid in pkls:
        with open(uid_to_path(out, uid), "rb") as f:
            got = pickle.load(f)["surf_wcs"]
        assert got.shape == sources[uid].shape and np.abs(got - sources[uid]).max() < 5e-2


def _torchrun_env(root):
    env = dict(os.environ, PYTHONPATH=root)
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(var, None)
    return env


@pytest.mark.cuda
def test_ldm_main_dp_world_size_one_over_nccl_on_card(cuda, tmp_path):
    # torchrun --nproc_per_node 1 ldm_main --dp (NCCL) trains as the same
    # command without --dp: equal per-step losses, K5 12 and K1 24 a step
    # (remat) + 12 a validation call, a pack without DDP's prefix
    import re
    import subprocess
    import sys

    from brepgen_tpu_torch.cli.build import build_denoiser
    from brepgen_tpu_torch.train.checkpoint import load_params

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    packs = os.path.join(root, "artifacts", "demo_round5", "all160k", "ckpt_packed")
    argv = ["--option", "edgez", "--max_face", "10", "--max_edge", "8", "--batch_size", "8",
            "--synthetic", "24", "--num_workers", "0", "--train_nepoch", "2", "--test_nepoch",
            "2", "--log_every", "1", "--remat", "on", "--env", "edgez",
            "--surfvae", os.path.join(packs, "surf_vae.npz"),
            "--edgevae", os.path.join(packs, "edge_vae.npz")]
    runs = {}
    for name, head in (("dp", ["-m", "torch.distributed.run", "--standalone",
                               "--nproc_per_node", "1"]), ("one", [])):
        extra = ["--dp"] if name == "dp" else []
        proc = subprocess.run([sys.executable, *head, "-m", "brepgen_tpu_torch.cli.ldm_main",
                               *argv, *extra, "--dir_name", str(tmp_path / name)], cwd=root,
                              env=_torchrun_env(root), capture_output=True, text=True,
                              timeout=600)
        assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
        m = re.search(r"(\d+) steps and (\d+) validation calls .* launches(?: on each of 1 "
                      r"ranks)? (\{.*\})", proc.stdout)
        steps, vals, counts = int(m.group(1)), int(m.group(2)), json.loads(m.group(3))
        assert counts["packed_attention_backward"] == 12 * steps
        assert counts["packed_attention"] == 24 * steps + 12 * vals
        with open(tmp_path / name / "edgez" / "edgez.jsonl") as f:
            runs[name] = [json.loads(line) for line in f]
    losses = {k: [r["loss"] for r in v if "loss" in r] for k, v in runs.items()}
    assert len(losses["dp"]) == steps >= 2
    np.testing.assert_allclose(losses["dp"], losses["one"], rtol=1e-5, atol=0)
    pack = tmp_path / "dp" / "edgez" / "epoch_2.npz"
    load_params(str(pack), build_denoiser("edgez"))  # strict: no "module." keys


@pytest.mark.cuda
def test_split_step_over_two_gloo_ranks_on_card(cuda, tmp_path):
    # two ranks share the card over gloo (tests/torch_port_dist.py) and take
    # one DDP step each on their rows, through K1/K5 for edgez; held to the
    # single-process step on the card: loss rtol 1e-5, gradients 1e-3 of
    # their norm, parameters 2.5e-4 where the gradient exceeds 1e-6 and the
    # two runs' difference (elsewhere both hold rounding noise, which Adam's
    # first step turns into +-lr: 2 lr, chip_smoke.py's phase dp rule)
    import pickle
    import subprocess
    import sys

    import torch_port_dist as D

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    init, out = f"file://{tmp_path / 'rendezvous'}", str(tmp_path / "out")
    procs = [subprocess.Popen([sys.executable, os.path.join(root, "tests", "torch_port_dist.py"),
                               "--rank", str(r), "--world", "2", "--init", init, "--out", out,
                               "--device", "cuda"], cwd=root, env=_torchrun_env(root),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in (0, 1)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), logs[0][-3000:] + logs[1][-3000:]
    torch.backends.cuda.matmul.allow_tf32 = False
    for stage in ("surfpos", "edgez"):
        LAUNCH_COUNTS["packed_attention_backward"] = 0
        want_metrics, want_params, want_grads = D.train_step(stage, device="cuda")
        if stage == "edgez":
            assert LAUNCH_COUNTS["packed_attention_backward"] == 1
        for r in (0, 1):
            with open(f"{out}.{r}.pkl", "rb") as f:
                metrics, params, grads = pickle.load(f)["train"][stage]
            for k, v in want_metrics.items():
                np.testing.assert_allclose(metrics[k], v, rtol=1e-5, err_msg=k)
            g_diff = sum(float(((grads[k] - g) ** 2).sum()) for k, g in want_grads.items())
            g_norm = sum(float((g ** 2).sum()) for g in want_grads.values())
            assert g_diff ** 0.5 <= 1e-3 * g_norm ** 0.5
            for k, v in want_params.items():
                diff = (params[k] - v).abs()
                if k in want_grads:
                    g = want_grads[k].abs()
                    live = (g > 1e-6) & (g > (grads[k] - want_grads[k]).abs())
                    assert not live.any() or diff[live].max() <= 2.5e-4, k
                assert diff.max() <= 2 * 5e-4, k


# ---- head width 16 (the entry check's flagship: width 64, 4 heads; the
# CLIs' --small: width 32, 2 heads): every kernel natively, f32 and bf16

DTYPE_RELS = [(torch.float32, 0.0), (torch.bfloat16, 2.0 ** -8)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", DTYPE_RELS)
@pytest.mark.parametrize("S", TILE_EDGES)
@pytest.mark.parametrize("entry", ["packed_attention", "packed_flash_attention"])
def test_d16_packed_attention_tile_edges_on_card(cuda, entry, dtype, rel, S):
    test_packed_attention_tile_edges_on_card(cuda, entry, dtype, rel, 16, S)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", DTYPE_RELS)
@pytest.mark.parametrize("S", TILE_EDGES)
def test_d16_set_attention_tile_edges_on_card(cuda, dtype, rel, S):
    test_set_attention_tile_edges_on_card(cuda, dtype, rel, 16, S)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", DTYPE_RELS)
@pytest.mark.parametrize("S", TILE_EDGES)
def test_d16_packed_backward_tile_edges_on_card(cuda, dtype, rel, S):
    test_packed_backward_tile_edges_on_card(cuda, dtype, rel, 16, S)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", DTYPE_RELS)
@pytest.mark.parametrize("kernel,B,S,W,H", [
    ("packed_attention", 16, 1800, 32, 2), ("packed_flash_attention", 2, 8400, 32, 2),
    ("set_attention", 16, 4000, 32, 2), ("packed_attention", 2, 120, 64, 4)])
def test_d16_forward_kernels_at_the_measured_shapes_on_card(cuda, kernel, dtype, rel, B, S,
                                                            W, H):
    # K1 at the --small deepcad edge stage, K2 at the long set, K3 at ABC,
    # K1 at the entry check's flagship (width 64, 4 heads): one launch each,
    # against the plain version in f32 on the same (bf16-valued) inputs
    qkv, mask = _inputs(B, S, W, seed=S + W)
    qkv = torch.from_numpy(qkv).to(cuda, dtype)
    mask = torch.from_numpy(mask).to(cuda)
    before = LAUNCH_COUNTS[kernel]
    if kernel == "set_attention":
        q, k, v = hopper._heads(qkv, H)
        got = set_attention(q, k, v, mask).transpose(1, 2).reshape(B, S, W).float()
    else:
        got = {"packed_attention": packed_attention,
               "packed_flash_attention": packed_flash_attention}[kernel](qkv, H, mask).float()
    assert LAUNCH_COUNTS[kernel] == before + 1
    want = packed_attention_reference(qkv.float(), H, mask)
    assert ((got - want).abs() <= rel * want.abs() + 1e-4).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [65, 601])
def test_d16_kernels_read_nothing_of_the_next_batch_or_head_on_card(cuda, dtype, S):
    test_packed_attention_reads_nothing_of_the_next_batch_on_card(cuda, dtype, 16, S)
    hopper.test_k5_reads_nothing_of_the_next_batch_on_card(cuda, dtype, 16, S)
    if dtype == torch.bfloat16:
        hopper.test_k3_bf16_tile_edges_and_no_read_across_heads_on_card(cuda, 16, S)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [65, 601])
def test_d16_k1_residuals_match_the_plain_ones_on_card(cuda, dtype, S):
    hopper.test_k1_statistics_match_the_plain_ones_on_card(cuda, dtype, 16, S)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_d16_k5_at_the_entry_flagship_training_shape_on_card(cuda, dtype):
    # K5 at B128 S600 W64 H4 (chip_smoke.py's D = 16 leg), given K1's
    # residuals, against its plain version and its sums in f64; two
    # launches bit-equal
    B, S, W, H = 128, 600, 64, 4
    qkv, dout, mask = hopper._inputs(cuda, B, S, W, dtype, seed=16)
    _, o32, stats = packed_attention_with_stats(qkv, H, mask)
    before = LAUNCH_COUNTS["packed_attention_backward"]
    got = packed_attention_backward(qkv, dout, H, mask, out=o32, stats=stats)
    assert LAUNCH_COUNTS["packed_attention_backward"] == before + 1
    assert torch.equal(got, packed_attention_backward(qkv, dout, H, mask, out=o32, stats=stats))
    hopper._hold_backward(got, qkv, dout, H, mask, hopper.REL[dtype])
