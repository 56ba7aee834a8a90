"""Port: the CUDA kernels (K1 packed attention, K2 its long-set entry, K3
per-head set attention, K4 Chamfer matrix, K5 the packed attention's
backward) against their plain versions, on the card.

Marked ``cuda``: they skip without a card. This file imports no JAX, so it
also runs on a machine without it (``--noconftest`` skips the JAX set-up of
``tests/conftest.py``):

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
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
        packed_attention(torch.zeros((1, 8, 3 * 48), device=cuda), 3)  # D = 16
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
    # K5 against its plain version in f32 on the same (bf16-valued) inputs:
    # both sum in f32, the kernel rounds its output once to the input type.
    # Sample 1 attends to one key, sample 2 to none (uniform P over S keys).
    B = 4
    qkv, mask = _inputs(B, S, W, seed=S + W)
    dout = np.random.default_rng(S).normal(size=(B, S, W)).astype(np.float32)
    qkv = torch.from_numpy(qkv).to(cuda, dtype)
    dout = torch.from_numpy(dout).to(cuda, dtype)
    mask = torch.from_numpy(mask).to(cuda)
    before = dict(LAUNCH_COUNTS)
    got = packed_attention_backward(qkv, dout, H, mask).float()
    want = packed_attention_backward_reference(qkv.float(), dout.float(), H, mask)
    assert LAUNCH_COUNTS["packed_attention_backward"] == before["packed_attention_backward"] + 1
    assert LAUNCH_COUNTS["packed_attention"] == before["packed_attention"]
    assert torch.isfinite(got).all()
    assert ((got - want).abs() <= rel * want.abs() + 1e-4).all(), (got - want).abs().max()


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
    with pytest.raises(ValueError):
        packed_attention_backward(torch.zeros((2, 8, 3 * 48), device=cuda),
                                  torch.zeros((2, 8, 48), device=cuda), 1)  # D = 48
    with pytest.raises(ValueError):
        packed_attention_backward(qkv, dout[:, :7], 1)  # dout [B, S-1, W]
    with pytest.raises(ValueError):
        packed_attention_backward(qkv, dout.bfloat16(), 1)  # mixed types
    with pytest.raises(ValueError):
        packed_attention_backward(qkv, dout.cpu(), 1)  # dout on another device
    with pytest.raises(ValueError):
        packed_attention_backward(qkv, torch.zeros((2, 64, 8), device=cuda).transpose(1, 2), 1)
    with pytest.raises(TypeError):
        packed_attention_backward(qkv.half(), dout.half(), 1)
    with pytest.raises(ValueError):
        packed_attention_backward(qkv, dout, 1, torch.zeros((2, 7), dtype=torch.bool,
                                                           device=cuda))


@pytest.mark.cuda
def test_chamfer_refuses_a_gradient(cuda):
    x = torch.zeros((2, 8, 3), device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward only"):
        chamfer_matrix(x, x.detach())
