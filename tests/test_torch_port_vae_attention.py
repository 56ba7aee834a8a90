"""Port: the edge VAE's attention core (``kernels/vae_attention.py``).

On the CPU: the plain version against ``SelfAttention1D``'s einsum path, the
rule that hands a call to the kernel (``takes_kernel``) and the module's use
of it, and the wrapper's refusals. Marked ``cuda`` (they skip without a
card): the kernel against the plain version in f32 and bf16, at the
production shape of the training step's edge encode and at ragged sizes and
lengths; the launches of one encode and one decode; the decoder's mid block
captured into a CUDA graph, replayed bit-equal to eager with its kernel nodes
counted. This file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_port_vae_attention.py
"""

import numpy as np
import pytest
import torch

from brepgen_tpu_torch.cli.build import seed_weights
from brepgen_tpu_torch.kernels import LAUNCH_COUNTS
from brepgen_tpu_torch.kernels import attention as _attention
from brepgen_tpu_torch.kernels import vae_attention as va
from brepgen_tpu_torch.nn import vae1d
from brepgen_tpu_torch.nn.layers import cast_compute


def _qkv(N, L, H, seed, dtype=torch.float32, device="cpu"):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=(N, L, H * 32)).astype(np.float32))
                 .to(device, dtype) for _ in range(3))


def _module(H, seed=0):
    m = vae1d.SelfAttention1D(32 * H, H)
    return seed_weights(m, torch.Generator().manual_seed(seed)).eval()


# --- CPU ---------------------------------------------------------------------------

@pytest.mark.parametrize("H", [1, 2, 16])
@pytest.mark.parametrize("L", [4, 8, 16])
def test_plain_version_matches_the_einsum_path(L, H):
    q, k, v = _qkv(6, L, H, seed=10 * L + H)
    want = _module(H).attend(q, k, v, torch.float32)
    got = va.vae_attention_reference(q, k, v, H)
    assert got.dtype == torch.float32
    assert (got - want).abs().max().item() <= 1e-6


def test_plain_version_rounds_once_to_bf16():
    q, k, v = _qkv(4, 4, 2, seed=3)
    got = va.vae_attention_reference(*(a.bfloat16() for a in (q, k, v)), 2)
    want = va.vae_attention_reference(*(a.bfloat16().float() for a in (q, k, v)), 2)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.bfloat16())


def test_takes_kernel_only_on_the_card_without_grad_at_head_width_32(monkeypatch):
    q, k, v = _qkv(3, 4, 2, seed=1)
    assert not va.takes_kernel(q, k, v, 2)  # the CPU
    monkeypatch.setattr(_attention, "_on_card", lambda t: True)
    assert va.takes_kernel(q, k, v, 2)
    assert va.takes_kernel(*(a.bfloat16() for a in (q, k, v)), 2)
    assert va.takes_kernel(*_qkv(3, va.MAX_LEN, 2, seed=2), 2)
    with torch.no_grad():
        assert va.takes_kernel(q.requires_grad_(), k, v, 2)
    assert not va.takes_kernel(q, k, v, 2)  # grad enabled, q requires grad
    q = q.detach()
    assert not va.takes_kernel(q, k, v, 4)  # D = 16
    assert not va.takes_kernel(q, k, v, 1)  # D = 64
    assert not va.takes_kernel(*_qkv(3, va.MAX_LEN + 1, 2, seed=2), 2)  # L = 5
    assert not va.takes_kernel(*(a.half() for a in (q, k, v)), 2)
    assert not va.takes_kernel(q, k.bfloat16(), v, 2)
    assert not va.takes_kernel(q.transpose(0, 1).contiguous().transpose(0, 1), k, v, 2)


def test_module_takes_the_einsum_path_on_the_cpu():
    m = _module(2)
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(5, 64, 4)).astype(np.float32))
    before = LAUNCH_COUNTS["vae_attention"]
    with torch.no_grad():
        got = m(x)
        h = m.norm(x).transpose(1, 2).contiguous()
        want = x + m.proj(m.attend(m.q(h), m.k(h), m.v(h), x.dtype)).transpose(1, 2)
    assert torch.equal(got, want)
    assert LAUNCH_COUNTS["vae_attention"] == before


@pytest.fixture
def stand_in(monkeypatch):
    """``_on_card`` forced and the launcher replaced by the plain version:
    the calls the module would hand the kernel, counted."""
    calls = []

    def launcher(q, k, v, num_heads):
        calls.append((tuple(q.shape), num_heads, torch.is_grad_enabled()))
        return va.vae_attention_reference(q, k, v, num_heads)

    monkeypatch.setattr(_attention, "_on_card", lambda t: True)
    monkeypatch.setattr(va, "vae_attention", launcher)
    return calls


def test_edge_vae_hands_each_mid_block_attention_to_the_kernel_without_grad(stand_in):
    vae = seed_weights(vae1d.EdgeVAE((16, 32, 64)), torch.Generator().manual_seed(2)).eval()
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(7, 32, 3)).astype(np.float32))
    with torch.no_grad():
        got = vae.encode_moments(x)
    assert stand_in == [((7, 4, 64), 2, False)] * 6
    assert (got - vae.encode_moments(x)).abs().max().item() <= 1e-5  # the einsum path
    stand_in.clear()
    with torch.no_grad():
        vae.decode(got[..., :3])
    assert len(stand_in) == 6
    stand_in.clear()
    vae.encode_moments(x)  # gradients of the parameters: the einsum path
    assert stand_in == []
    vae.requires_grad_(False)
    vae.encode_moments(x)  # nothing requires grad
    assert len(stand_in) == 6


def test_wrapper_refuses_what_the_kernel_does_not_take():
    q, k, v = _qkv(3, 4, 2, seed=6)
    with pytest.raises(ValueError, match="CUDA device"):
        va.vae_attention(q, k, v, 2)
    with pytest.raises(TypeError, match="float32 or all bfloat16"):
        va.vae_attention(q.half(), k.half(), v.half(), 2)
    with pytest.raises(TypeError, match="float32 or all bfloat16"):
        va.vae_attention(q, k.bfloat16(), v, 2)
    with pytest.raises(ValueError, match="heads of width 32"):
        va.vae_attention(q, k, v, 4)
    with pytest.raises(ValueError, match=r"L must be in \[1, 4\]"):
        va.vae_attention(*_qkv(3, 5, 2, seed=6), 2)
    with pytest.raises(ValueError, match="one \\[N, L, C\\] shape"):
        va.vae_attention(q, k[:2], v, 2)
    with pytest.raises(ValueError, match="one \\[N, L, C\\] shape"):
        va.vae_attention(q[0], k[0], v[0], 2)
    with pytest.raises(ValueError, match="contiguous"):
        va.vae_attention(q.transpose(0, 1).contiguous().transpose(0, 1), k, v, 2)
    with pytest.raises(RuntimeError, match="forward only"):
        va.vae_attention(q.requires_grad_(), k, v, 2)


# --- card --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel,tol", [(torch.float32, 0.0, 1e-5),
                                           (torch.bfloat16, 2.0 ** -8, 1e-5)])
@pytest.mark.parametrize("N,L,H", [(76800, 4, 16), (1001, 4, 16), (7, 3, 1), (130, 2, 2),
                                   (3, 1, 16)])
def test_kernel_matches_plain_on_card(cuda, dtype, rel, tol, N, L, H):
    # against the plain version in f32 on the same inputs: the kernel works in
    # f32 and rounds its output once to the input type
    q, k, v = _qkv(N, L, H, seed=N + L + H, dtype=dtype, device=cuda)
    before = LAUNCH_COUNTS["vae_attention"]
    with torch.no_grad():
        got = va.vae_attention(q, k, v, H)
    assert LAUNCH_COUNTS["vae_attention"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = va.vae_attention_reference(q.float(), k.float(), v.float(), H)
    err = (got.float() - want).abs()
    assert (err <= rel * want.abs() + tol).all(), err.max().item()


@pytest.mark.cuda
def test_kernel_launches_nothing_for_no_sets_on_card(cuda):
    q, k, v = _qkv(0, 4, 16, seed=0, device=cuda)
    before = LAUNCH_COUNTS["vae_attention"]
    assert va.vae_attention(q, k, v, 16).shape == (0, 4, 512)
    assert LAUNCH_COUNTS["vae_attention"] == before


@pytest.fixture
def edge_vae(cuda):
    return seed_weights(vae1d.EdgeVAE(), torch.Generator().manual_seed(3)).to(cuda).eval()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_encode_and_decode_launch_six_each_on_card(cuda, edge_vae, dtype, monkeypatch):
    # f32 products in f32 (cuDNN's convolutions default to TF32), so that the
    # two paths' difference is the attention's
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    vae = cast_compute(edge_vae, dtype)
    x = torch.from_numpy(np.random.default_rng(7).normal(size=(300, 32, 3))
                         .astype(np.float32)).to(cuda)
    with torch.no_grad():
        before = LAUNCH_COUNTS["vae_attention"]
        moments = vae.encode_moments(x)
        assert LAUNCH_COUNTS["vae_attention"] == before + 6
        decoded = vae.decode(moments[..., :3])
        assert LAUNCH_COUNTS["vae_attention"] == before + 12
        monkeypatch.setattr(va, "takes_kernel", lambda *a: False)
        einsum_moments = vae.encode_moments(x)
        einsum_decoded = vae.decode(moments[..., :3])
    assert LAUNCH_COUNTS["vae_attention"] == before + 12
    # the einsum path rounds its scores and probabilities to the module's type
    bar = 1e-4 if dtype == torch.float32 else 0.05
    for got, want in ((moments, einsum_moments), (decoded, einsum_decoded)):
        err = (got - want).abs().max().item()
        assert err <= bar * want.abs().max().item(), (err, want.abs().max().item())


@pytest.mark.cuda
def test_captured_decoder_mid_block_replays_bit_equal_with_its_nodes_counted_on_card(
        cuda, edge_vae):
    # the decoder's six attentions; the whole decode does not capture (the
    # FIR resamplers copy their taps from the host at every call)
    from brepgen_tpu_torch.sampling import aot

    mid = cast_compute(edge_vae, torch.bfloat16).decoder.mid
    h = torch.from_numpy(np.random.default_rng(8).normal(size=(1024, 512, 4))
                         .astype(np.float32)).to(cuda, torch.bfloat16)
    with torch.no_grad():
        eager = mid(h)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            mid(h)  # warm-up outside the capture
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        before = LAUNCH_COUNTS["vae_attention"]
        with torch.cuda.graph(graph):
            out = mid(h)
        recorded = {"vae_attention": LAUNCH_COUNTS["vae_attention"] - before}
        assert aot.graph_launches(aot.kernel_names(graph), recorded) == {"vae_attention": 6}
        graph.instantiate()
        graph.replay()
        torch.cuda.synchronize()
    assert torch.equal(out, eager)
