"""Port: K5, the packed attention's backward, and the gradients of every
attention entry, against the JAX package on the CPU.

K5's plain version is held to ``jax.vjp`` of ``_packed_reference`` and to
the Pallas backward ``_packed_backward`` in interpret mode; the K2 and K3
routes' backward (recomputed through the plain version) to ``jax.vjp`` of
``_xla_attention``. Bars: 1e-4 absolute in f32 (sums in another order).
The Pallas kernel pads S to its block with masked keys, so a query row with
no real key averages over the padded length there; it is compared only on
batches whose rows all have a real key, and the all-masked row is held to
torch autograd of the port's plain forward instead (uniform P over the S
real keys, the forward's convention).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brepgen_tpu.kernels import attention as jattn
from brepgen_tpu_torch.kernels import LAUNCH_COUNTS
from brepgen_tpu_torch.kernels import attention as kattn
from brepgen_tpu_torch.kernels import set_attention as kset
from brepgen_tpu_torch.kernels.chamfer import chamfer_matrix
from brepgen_tpu_torch.nn.transformer import routed_attention

TOL = 1e-4


def _inputs(B, S, W, seed, all_masked=False):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(B, S, 3 * W)).astype(np.float32)
    dout = rng.normal(size=(B, S, W)).astype(np.float32)
    mask = rng.random((B, S)) < np.linspace(0.1, 0.6, B)[:, None]
    mask[:, 0] = False
    mask[0] = False
    mask[1, 1:] = True  # one real key
    if all_masked:
        mask[2] = True  # no real key
    mask[-1, S - 5:] = True  # padded tail
    return qkv, dout, mask


def _max_diff(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


# D = W / H: 32 and 64; S ragged against every block
@pytest.mark.parametrize("S,W,H", [(37, 64, 2), (50, 128, 2), (70, 256, 8), (129, 128, 2)])
def test_backward_plain_matches_jax_vjp(S, W, H):
    qkv, dout, mask = _inputs(4, S, W, seed=S + W, all_masked=True)
    _, vjp = jax.vjp(lambda x: jattn._packed_reference(x, H, jnp.asarray(mask)),
                     jnp.asarray(qkv))
    (want,) = vjp(jnp.asarray(dout))
    got = kattn.packed_attention_backward_reference(
        torch.from_numpy(qkv), torch.from_numpy(dout), H, torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == qkv.shape
    assert _max_diff(got, want) <= TOL


@pytest.mark.parametrize("S,W,H,block_q", [(37, 64, 2, 16), (70, 256, 8, 32), (20, 128, 2, 8)])
def test_backward_plain_matches_pallas_interpret(S, W, H, block_q):
    qkv, dout, mask = _inputs(3, S, W, seed=S * 3 + W)
    want = jattn._packed_backward(jnp.asarray(qkv), jnp.asarray(dout), H, jnp.asarray(mask),
                                  block_q, True)
    got = kattn.packed_attention_backward_reference(
        torch.from_numpy(qkv), torch.from_numpy(dout), H, torch.from_numpy(mask))
    assert _max_diff(got, want) <= TOL


def test_all_masked_row_matches_autograd_of_the_plain_forward():
    qkv, dout, mask = _inputs(4, 45, 128, seed=3, all_masked=True)
    x = torch.from_numpy(qkv).requires_grad_()
    m = torch.from_numpy(mask)
    (want,) = torch.autograd.grad(kattn.packed_attention_reference(x, 4, m), x,
                                  torch.from_numpy(dout))
    got = kattn.packed_attention_backward_reference(x.detach(), torch.from_numpy(dout), 4, m)
    assert _max_diff(got, want) <= 1e-5
    # the all-masked sample attends uniformly: every key, masked or not, gets
    # dV = the mean of dO over the rows
    W = 128
    np.testing.assert_allclose(got[2, :, 2 * W:].numpy(),
                               np.broadcast_to(dout[2].mean(0), (45, W)), atol=1e-5)


def test_bf16_plain_backward_sums_in_f32():
    qkv, dout, mask = _inputs(3, 33, 64, seed=5)
    x, g, m = torch.from_numpy(qkv), torch.from_numpy(dout), torch.from_numpy(mask)
    got = kattn.packed_attention_backward_reference(x.bfloat16(), g.bfloat16(), 2, m)
    want = kattn.packed_attention_backward_reference(x.bfloat16().float(),
                                                     g.bfloat16().float(), 2, m)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.bfloat16())


def _stand_in_launchers(monkeypatch):
    """Take the kernel path on the CPU: each launcher returns its plain
    result detached, with no grad_fn, as a ctypes-filled output is."""
    calls = {"packed": 0, "backward": 0, "set": 0}

    def launch(name, qkv, H, mask):
        calls["packed"] += 1
        plain = (kattn.packed_attention_reference if name == "packed_attention"
                 else kattn.packed_flash_attention_reference)
        return plain(qkv, H, mask).detach()

    def launch_backward(qkv, dout, H, mask):
        calls["backward"] += 1
        return kattn.packed_attention_backward_reference(qkv, dout, H, mask).detach()

    def launch_set(q, k, v, mask):
        calls["set"] += 1
        return kset.set_attention_reference(q, k, v, mask).detach()

    monkeypatch.setattr(kattn, "_on_card", lambda t: True)
    monkeypatch.setattr(kattn, "_launch", launch)
    monkeypatch.setattr(kattn, "_launch_backward", launch_backward)
    monkeypatch.setattr(kset, "_launch", launch_set)
    return calls


@pytest.mark.parametrize("route", ["packed", "packed_flash", "per_head"])
def test_kernel_entries_carry_gradients(monkeypatch, route):
    # F3: on the card the kernels' outputs come from ctypes with no grad_fn;
    # each routed entry must still give autograd's gradients of the plain
    # version (K1 through K5, K2 and K3 through the plain recompute)
    calls = _stand_in_launchers(monkeypatch)
    B, S, W, H = 4, 30, 128, 4
    qkv, dout, mask = _inputs(B, S, W, seed=11, all_masked=True)
    m, g = torch.from_numpy(mask), torch.from_numpy(dout)
    x = torch.from_numpy(qkv).requires_grad_()
    (want,) = torch.autograd.grad(kattn.packed_attention_reference(x, H, m), x, g)
    x = torch.from_numpy(qkv).requires_grad_()
    if route == "packed":
        out = routed_attention(x, H, m)  # K1 at this size
    elif route == "packed_flash":
        out = kattn.packed_flash_attention(x, H, m)
    else:
        monkeypatch.setattr(kattn, "PACKED_RESIDENT_BYTES", 0)  # the per-head route
        out = routed_attention(x, H, m)
    assert out.grad_fn is not None
    (got,) = torch.autograd.grad(out, x, g)
    assert _max_diff(got, want) <= 1e-5
    expected = {"packed": {"packed": 1, "backward": 1, "set": 0},
                "packed_flash": {"packed": 1, "backward": 0, "set": 0},
                "per_head": {"packed": 0, "backward": 0, "set": 1}}[route]
    assert calls == expected


def test_no_grad_takes_the_forward_alone(monkeypatch):
    calls = _stand_in_launchers(monkeypatch)
    qkv, _, mask = _inputs(3, 20, 64, seed=2)
    with torch.no_grad():
        out = kattn.packed_attention(torch.from_numpy(qkv), 2, torch.from_numpy(mask))
    assert out.grad_fn is None and calls == {"packed": 1, "backward": 0, "set": 0}


def test_chamfer_is_forward_only():
    x = torch.randn((2, 8, 3), requires_grad=True)
    with pytest.raises(RuntimeError, match="forward only"):
        chamfer_matrix(x, x.detach())
    with torch.no_grad():
        assert chamfer_matrix(x, x).shape == (2, 2)


@pytest.mark.parametrize("D", [32, 64])
def test_k2_and_k3_backward_match_jax_vjp(D):
    # the CPU routes (plain forward, backward recomputed under autograd)
    # against jax.vjp of the XLA attention
    B, S, H = 3, 41, 2
    qkv, dout, mask = _inputs(B, S, H * D, seed=D, all_masked=True)
    m = torch.from_numpy(mask)
    split = lambda a: a.reshape(B, S, H, D).transpose(0, 2, 1, 3)  # noqa: E731
    q, k, v = (np.ascontiguousarray(split(a)) for a in np.split(qkv, 3, axis=-1))
    g = np.ascontiguousarray(split(dout))
    _, vjp = jax.vjp(lambda a, b, c: jattn._xla_attention(a, b, c, jnp.asarray(mask)),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got = torch.autograd.grad(kset.set_attention(*ts, m), ts, torch.from_numpy(g))
    for a, b in zip(got, want):
        assert _max_diff(a, b) <= TOL
    _, vjp = jax.vjp(lambda x: jattn._packed_reference(x, H, jnp.asarray(mask)),
                     jnp.asarray(qkv))
    (want,) = vjp(jnp.asarray(dout))
    x = torch.from_numpy(qkv).requires_grad_()
    before = LAUNCH_COUNTS["packed_flash_attention"]
    (got,) = torch.autograd.grad(kattn.packed_flash_attention(x, H, m), x,
                                 torch.from_numpy(dout))
    assert _max_diff(got, want) <= TOL
    assert LAUNCH_COUNTS["packed_flash_attention"] == before  # the CPU launches nothing
