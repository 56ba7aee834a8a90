"""Port: the residual add and LayerNorm in one kernel (``kernels/add_layer_norm.py``).

On the CPU: the encoder that hands each layer's FFN output to the next norm
(``EncoderLayer.carry``) against the formulation it replaced (each residual
added in a pass of its own, then the norm), bit for bit in f32 and bf16,
forward and gradients, with every ``remat``, dropout seeds and the
data- and tensor-parallel dropout splits; the MLP embedders likewise; the
rule that hands a norm to the kernel (``takes_kernel``: the card, no
gradient), the wrapper's refusals, which a norm on the card raises rather
than falling back, and the kernel launches of one denoiser call. Marked
``cuda`` (they skip without a card): the kernel against the plain version at the
sampling cells' shapes, in f32 and bf16, with and without the residual and
SiLU; a captured denoiser call replayed bit-equal to eager with its kernel
nodes counted. This file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_port_add_layer_norm.py
"""

import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from brepgen_tpu_torch.cli.build import seed_weights
from brepgen_tpu_torch.kernels import LAUNCH_COUNTS
from brepgen_tpu_torch.kernels import add_layer_norm as aln
from brepgen_tpu_torch.kernels import attention as _attention
from brepgen_tpu_torch.nn import denoiser
from brepgen_tpu_torch.nn import transformer as ttrans
from brepgen_tpu_torch.nn.layers import LayerNorm, MLPEmbedder, cast_compute
from brepgen_tpu_torch.parallel.distributed import RowSplit

EPS = 1e-6


def _seeded(module, seed):
    """Seeded weights with norms away from scale 1 and bias 0."""
    gen = torch.Generator().manual_seed(seed)
    seed_weights(module, gen)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, LayerNorm):
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.uniform_(-0.2, 0.2, generator=gen)
    return module


def _rows(shape, seed, dtype=torch.float32, device="cpu", offset=0.0):
    rng = np.random.default_rng(seed)
    a = rng.normal(offset, 1.5, size=shape).astype(np.float32)
    return torch.from_numpy(a).to(device, dtype)


# --- the formulation the carry replaced ----------------------------------------------

def _norm(m, x):
    return F.layer_norm(x.float(), m.normalized_shape, m.weight, m.bias, m.eps).to(x.dtype)


def _previous_layer(layer, x, key_padding_mask, seed, row_split):
    gen = None
    if seed is not None and layer.dropout != 0.0:
        gen = torch.Generator(device=x.device)
        gen.manual_seed(seed)

    def drop(h, cols=None):
        return h if gen is None else ttrans.dropout(h, layer.dropout, gen, row_split, cols)

    x = x + drop(layer.attn(_norm(layer.norm1, x), key_padding_mask))
    return x + drop(layer.fc2(drop(F.relu(layer.fc1(_norm(layer.norm2, x))), layer.ffn_split)))


def _previous_encoder(enc, x, key_padding_mask, train, generator):
    drop = train and enc.dropout > 0.0
    for i in range(enc.num_layers):
        layer = functools.partial(_previous_layer, getattr(enc, f"layer_{i}"))
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator)) if drop else None
        if enc.remat and torch.is_grad_enabled():
            kw = {}
            if enc.remat == "dots":
                kw["context_fn"] = functools.partial(
                    torch.utils.checkpoint.create_selective_checkpoint_contexts,
                    ttrans.dots_policy)
            x = torch.utils.checkpoint.checkpoint(layer, x, key_padding_mask, seed,
                                                  enc.row_split, use_reentrant=False, **kw)
        else:
            x = layer(x, key_padding_mask, seed, enc.row_split)
    return _norm(enc.final_norm, x)


def _encoder(remat, dtype, split=False):
    enc = _seeded(ttrans.TransformerEncoder(32, 2, 64, 3, remat=remat), seed=1)
    if split:  # rank 1 of 2 data ranks, rank 0 of 2 model ranks' FFN columns
        enc.row_split = RowSplit(1, 2)
        for i in range(enc.num_layers):
            getattr(enc, f"layer_{i}").ffn_split = RowSplit(0, 2)
    return cast_compute(enc, dtype)


def _grads(module):
    return {n: p.grad.clone() for n, p in module.named_parameters()}


# --- CPU ---------------------------------------------------------------------------

@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("remat", ttrans.REMATS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_carry_equals_the_previous_formulation_bit_for_bit(dtype, remat, split):
    enc = _encoder(remat, dtype, split)
    x = _rows((3, 10, 32), seed=2, dtype=dtype, offset=0.3)
    mask = torch.zeros(3, 10, dtype=torch.bool)
    mask[1, 7:] = True
    runs = {}
    for name, fn in (("carry", enc), ("previous", functools.partial(_previous_encoder, enc))):
        with torch.no_grad():
            evaluated = fn(x, mask, False, None)
        enc.zero_grad(set_to_none=True)
        trained = fn(x.clone().requires_grad_(), mask, True, torch.Generator().manual_seed(5))
        trained.float().square().sum().backward()
        runs[name] = (evaluated, trained.detach(), _grads(enc))
    (e1, t1, g1), (e0, t0, g0) = runs["carry"], runs["previous"]
    assert e1.dtype == dtype and torch.equal(e1, e0)
    assert torch.equal(t1, t0)
    assert not torch.equal(t1, e1)  # the dropout masks act
    assert g1.keys() == g0.keys() and all(torch.equal(g1[k], g0[k]) for k in g1)


def test_layer_forward_adds_its_carry():
    layer = cast_compute(_seeded(ttrans.EncoderLayer(32, 2, 64), seed=3), torch.bfloat16)
    x = _rows((2, 9, 32), seed=4, dtype=torch.bfloat16)
    with torch.no_grad():
        got = layer(x)
        want = _previous_layer(layer, x, None, None, None)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embedder_equals_linear_norm_silu_linear(dtype):
    m = cast_compute(_seeded(MLPEmbedder(6, 32, 5), seed=6), dtype)
    x = _rows((4, 7, 6), seed=7, dtype=dtype)
    with torch.no_grad():
        got = m(x)
        want = m.fc2(F.silu(_norm(m.norm, m.fc1(x))))
    assert torch.equal(got, want)


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_version_rounds_the_sum_and_the_norm_to_the_type(dtype, silu):
    norm = _seeded(LayerNorm(24), seed=8)
    x, d = _rows((5, 24), seed=9, dtype=dtype), _rows((5, 24), seed=10, dtype=dtype)
    s, y = aln.add_layer_norm_reference(x, d, norm.weight, norm.bias, EPS, silu)
    assert s.dtype == y.dtype == dtype and torch.equal(s, x + d)
    want = _norm(norm, x + d)
    assert torch.equal(y, F.silu(want) if silu else want)
    s, y = norm.add_forward(x)
    assert s is x and torch.equal(y, _norm(norm, x))


def test_takes_kernel_only_on_the_card_without_grad(monkeypatch):
    norm = LayerNorm(64)
    x, d = _rows((3, 5, 64), seed=1), _rows((3, 5, 64), seed=2)
    w, b = norm.weight, norm.bias
    assert not aln.takes_kernel(x, d, w, b)  # the CPU
    monkeypatch.setattr(_attention, "_on_card", lambda t: True)
    assert not aln.takes_kernel(x, d, w, b)  # grad enabled, the weights require grad
    with torch.no_grad():
        assert aln.takes_kernel(x, d, w, b)
        assert aln.takes_kernel(x, None, w, b)
        assert aln.takes_kernel(x.bfloat16(), d.bfloat16(), w, b)
    w, b = w.detach(), b.detach()
    assert aln.takes_kernel(x, d, w, b)  # nothing requires grad
    assert not aln.takes_kernel(x, d.requires_grad_(), w, b)
    assert not aln.takes_kernel(x.requires_grad_(), None, w, b)


def test_norm_on_the_card_raises_on_what_the_kernel_does_not_take(monkeypatch):
    """On the card without gradients every norm goes to the kernel's entry,
    which raises on a layout, type or width it does not take: no quiet
    fallback to the plain path."""
    monkeypatch.setattr(_attention, "_on_card", lambda t: True)
    norm = LayerNorm(64)
    x, d = _rows((3, 5, 64), seed=1), _rows((3, 5, 64), seed=2)
    strided = x.transpose(0, 1).contiguous().transpose(0, 1)
    with torch.no_grad():
        with pytest.raises(ValueError, match="contiguous"):
            norm.add_forward(strided, d)
        misaligned = torch.cat([d.new_zeros(1), d.flatten()])[1:].view(d.shape)  # 4 bytes in
        with pytest.raises(ValueError, match="16-byte aligned"):
            norm(x, misaligned)
        with pytest.raises(TypeError, match="float32 or both bfloat16"):
            norm(x.half(), d.half())
        with pytest.raises(TypeError, match="float32 or both bfloat16"):
            norm.add_forward(x, d.bfloat16())
        with pytest.raises(ValueError, match="multiple of 8"):
            LayerNorm(12)(x[..., :12])
        with pytest.raises(ValueError, match="multiple of 8"):
            LayerNorm(aln.MAX_WIDTH + 8)(_rows((2, aln.MAX_WIDTH + 8), seed=3))
        with pytest.raises(ValueError, match="CUDA device"):  # taken: the launch's own check
            norm.add_forward(x, d)
        with pytest.raises(ValueError, match="CUDA device"):
            MLPEmbedder(6, 64)(_rows((2, 6), seed=4))
    s, y = norm.add_forward(x, d)  # with gradients: the plain path
    assert torch.equal(s, x + d) and torch.equal(y, _norm(norm, x + d).detach())


def test_wrapper_refuses_what_the_kernel_does_not_take():
    norm = LayerNorm(16)
    w, b = norm.weight.detach(), norm.bias.detach()
    x = _rows((4, 16), seed=1)
    with pytest.raises(ValueError, match="CUDA device"):
        aln.add_layer_norm(x, x, w, b, EPS)
    with pytest.raises(ValueError, match="multiple of 8"):
        aln.add_layer_norm(x[:, :12], None, w[:12], b[:12], EPS)
    with pytest.raises(TypeError, match="float32 or both bfloat16"):
        aln.add_layer_norm(x, x.bfloat16(), w, b, EPS)
    with pytest.raises(TypeError, match="weight and bias"):
        aln.add_layer_norm(x, None, w.bfloat16(), b, EPS)
    with pytest.raises(ValueError, match="x's shape"):
        aln.add_layer_norm(x, x[:2], w, b, EPS)
    with pytest.raises(ValueError, match="contiguous"):
        aln.add_layer_norm(_rows((16, 4), seed=2).t(), None, w, b, EPS)
    with pytest.raises(RuntimeError, match="forward only"):
        aln.add_layer_norm(x.requires_grad_(), None, w, b, EPS)


@pytest.fixture
def stand_in(monkeypatch):
    """``_on_card`` forced (the plain attention takes no kernel) and the
    launcher replaced by the plain version: the norms handed to the kernel,
    counted by their rows."""
    calls = []

    def launcher(x, delta, weight, bias, eps, silu=False, keep_sum=True):
        calls.append((x.numel() // x.shape[-1], delta is not None, silu))
        s, y = aln.add_layer_norm_reference(x, delta, weight, bias, eps, silu)
        return (s if delta is None or keep_sum else None), y

    monkeypatch.setattr(_attention, "_on_card", lambda t: True)
    monkeypatch.setattr(aln, "add_layer_norm", launcher)
    return calls


def token_norms(net, noisy_streams):
    """Norm launches of one denoiser call over tokens: two a layer and the
    final norm, an embedder's for each noisy stream, the head's."""
    return 2 * net.encoder.num_layers + 1 + noisy_streams + 1


def test_one_edge_call_hands_every_norm_to_the_kernel(stand_in):
    # production widths (12 layers), few tokens; the cascade's edgez call:
    # two noisy streams, the other three embedded once a stage (cond_embed)
    net = _seeded(denoiser.make_edgez_net(attn_impl="plain"), seed=11).eval()
    cast_compute(net, torch.bfloat16)
    B, S = 2, 6
    streams = {n: _rows((B, S, d), seed=i) for i, (n, d) in enumerate(net.stream_dims.items())}
    noisy = {k: streams[k] for k in ("edgez", "vertpos")}
    with torch.no_grad():
        cond = net.embed_streams({k: v for k, v in streams.items() if k not in noisy})
        stand_in.clear()
        got = net.denoise(noisy, 500, cond)
    assert token_norms(net, 2) == 28
    tokens = [c for c in stand_in if c[0] == B * S]
    assert len(tokens) == 28 and len(stand_in) == 29  # and the time embedding's, on B rows
    assert stand_in[2] == (B, False, True)  # time embedding, after the two streams
    assert sum(not d and s for _, d, s in stand_in) == 2 + 1 + 1  # embedders, head
    assert sum(d for _, d, _ in stand_in) == 2 * 12  # every norm but layer 0's norm1
    with torch.no_grad():
        assert torch.equal(got, net.denoise(noisy, 500, cond))  # the plain launcher, again
    stand_in.clear()
    with torch.no_grad():
        net(tuple(streams.values()), 500)  # training's validation call: all five streams
    assert len(stand_in) == token_norms(net, 5) + 1


def test_training_keeps_the_plain_path(stand_in):
    net = _seeded(denoiser.make_edgez_net(width=32, num_heads=2, ffn_width=64, num_layers=2,
                                          attn_impl="plain"), seed=12)
    streams = [_rows((2, 6, d), seed=i) for i, d in enumerate(net.stream_dims.values())]
    net(streams, 10, train=True, generator=torch.Generator().manual_seed(0)).sum().backward()
    assert stand_in == []


# --- card --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _hold(got, want, dtype):
    """y as the smoke holds it: within one bf16 step (``chip_smoke.bf16_steps``)
    in bf16, within ``ALN_F32_TOL`` (1e-5) in f32."""
    import chip_smoke

    if dtype == torch.bfloat16:
        err = chip_smoke.bf16_steps(torch, got, want)
        assert err <= 1, err
    else:
        err = (got - want).abs().max().item()
        assert err <= chip_smoke.ALN_F32_TOL, err


@pytest.mark.cuda
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S", [(16, 1800), (16, 4000)])
def test_kernel_matches_plain_on_card(cuda, B, S, dtype, residual):
    norm = _seeded(LayerNorm(768), seed=S).to(cuda)
    x = _rows((B, S, 768), seed=1, dtype=dtype, device=cuda, offset=0.4)
    d = _rows((B, S, 768), seed=2, dtype=dtype, device=cuda) if residual else None
    with torch.no_grad():
        before = LAUNCH_COUNTS["add_layer_norm"]
        s, y = aln.add_layer_norm(x, d, norm.weight, norm.bias, norm.eps)
        _, z = aln.add_layer_norm(x, d, norm.weight, norm.bias, norm.eps, silu=True,
                                  keep_sum=False)
        assert LAUNCH_COUNTS["add_layer_norm"] == before + 2
        want_s, want_y = aln.add_layer_norm_reference(x, d, norm.weight, norm.bias, norm.eps)
    assert y.dtype == z.dtype == dtype and y.shape == z.shape == x.shape
    assert torch.equal(s, want_s)  # the new residual, bit for bit
    if not residual:
        assert s is x
    _hold(y, want_y, dtype)
    _hold(z, F.silu(y), dtype)  # SiLU of the kernel's own rounded norm


@pytest.mark.cuda
def test_kernel_widths_and_no_rows_on_card(cuda):
    for W in (8, 32, 256, 1024):
        norm = _seeded(LayerNorm(W), seed=W).to(cuda)
        for dtype in (torch.float32, torch.bfloat16):
            x, d = (_rows((37, W), seed=W + i, dtype=dtype, device=cuda) for i in range(2))
            with torch.no_grad():
                s, y = aln.add_layer_norm(x, d, norm.weight, norm.bias, norm.eps)
                want_s, want_y = aln.add_layer_norm_reference(x, d, norm.weight, norm.bias,
                                                              norm.eps)
            assert torch.equal(s, want_s)
            _hold(y, want_y, dtype)
    before = LAUNCH_COUNTS["add_layer_norm"]
    with torch.no_grad():
        s, y = aln.add_layer_norm(x[:0], None, norm.weight, norm.bias, norm.eps)
    assert y.shape == (0, 1024) and LAUNCH_COUNTS["add_layer_norm"] == before


@pytest.mark.cuda
def test_captured_denoiser_call_replays_bit_equal_with_its_nodes_counted_on_card(cuda):
    from brepgen_tpu_torch.sampling import aot

    net = cast_compute(_seeded(denoiser.make_edgez_net(attn_impl="kernel"), seed=13).to(cuda),
                       torch.bfloat16).eval()
    streams = {n: _rows((2, 1800, d), seed=i, device=cuda)
               for i, (n, d) in enumerate(net.stream_dims.items())}
    noisy = {k: streams[k] for k in ("edgez", "vertpos")}
    t = torch.full((), 500, device=cuda)  # on the card, as the cascade's captured calls
    with torch.no_grad():
        cond = net.embed_streams({k: v for k, v in streams.items() if k not in noisy})
        before = dict(LAUNCH_COUNTS)
        eager = net.denoise(noisy, t, cond)
        launches = {k: LAUNCH_COUNTS[k] - before[k] for k in LAUNCH_COUNTS}
        assert launches["add_layer_norm"] == token_norms(net, 2) + 1  # + the time embedding
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            net.denoise(noisy, t, cond)  # warm-up outside the capture
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        before = dict(LAUNCH_COUNTS)
        with torch.cuda.graph(graph):
            out = net.denoise(noisy, t, cond)
        recorded = {k: LAUNCH_COUNTS[k] - before[k] for k in LAUNCH_COUNTS}
        assert aot.graph_launches(aot.kernel_names(graph), recorded) == {
            "add_layer_norm": 29, "packed_attention": 12}
        graph.instantiate()
        graph.replay()
        torch.cuda.synchronize()
    assert torch.equal(out, eager)
