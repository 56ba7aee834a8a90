"""Port: the bench's captured steps on the card.

``brepgen_tpu_torch.bench`` times each step as replays of a CUDA graph
captured through ``StageGraphs``. These tests hold a replay to the same step
run eagerly (bit-equal), and the K1 launches the graph records per edge step
to the layer count (and K7's to the step's norms). Marked ``cuda``: they skip without a card. This file
imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_port_bench_cuda.py
"""

import pytest
import torch

from brepgen_tpu_torch import bench
from brepgen_tpu_torch.cli.build import ARCHS, build_denoiser, seed_weights
from brepgen_tpu_torch.kernels import LAUNCH_COUNTS
from brepgen_tpu_torch.nn.layers import cast_compute
from brepgen_tpu_torch.sampling.aot import StageGraphs


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the steps replay CUDA graphs of the kernels")
    return torch.device("cuda")


def _net(stage, arch, dtype, device):
    net = build_denoiser(stage, arch=arch)
    net = seed_weights(net, torch.Generator().manual_seed(0)).to(device).eval()
    return cast_compute(net, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,dtype", [("production", torch.bfloat16),
                                        ("small", torch.float32)])
@pytest.mark.parametrize("stage,S", [("surfpos", bench.NS), ("edgez", bench.NS * bench.NE),
                                     ("edgez", 48 * 40)])
def test_captured_step_equals_eager_on_card(cuda, arch, dtype, stage, S):
    B = 4
    gen = torch.Generator(device=cuda).manual_seed(S)
    if stage == "surfpos":
        step, x, consts = bench.surf_step(_net(stage, arch, dtype, cuda)), \
            torch.randn((B, S, 6), generator=gen, device=cuda), (None, None, None)
    else:
        mask = torch.rand((B, S), generator=gen, device=cuda) < 0.3
        mask[:, 0] = False
        step = bench.edge_step(_net(stage, arch, dtype, cuda))
        x = torch.randn((B, S, 18), generator=gen, device=cuda)
        consts = (torch.randn((B, S, 60), generator=gen, device=cuda), mask, None)
    with torch.inference_mode():
        eager = step(x, torch.tensor(bench.T_EVAL, device=cuda), *consts)
        run = StageGraphs(None).stage(stage, step, consts, {}, dtype)
        run(torch.zeros_like(x), 0)  # the capture, on other inputs
        before = dict(LAUNCH_COUNTS)
        captured = run(x, bench.T_EVAL)
    assert torch.equal(captured, eager)
    layers = ARCHS[arch]["denoiser"]["num_layers"]
    k1 = LAUNCH_COUNTS["packed_attention"] - before["packed_attention"]
    assert k1 == (layers if stage == "edgez" else 0)


@pytest.mark.cuda
def test_time_steps_counts_k1_per_edge_step_on_card(cuda):
    net = _net("edgez", "production", torch.bfloat16, cuda)
    S, B = 32 * 30, 2
    gen = torch.Generator(device=cuda).manual_seed(0)
    consts = (torch.randn((B, S, 60), generator=gen, device=cuda),
              torch.zeros((B, S), dtype=torch.bool, device=cuda), None)
    seconds, launches = bench.time_steps(
        bench.edge_step(net), torch.randn((B, S, 18), generator=gen, device=cuda), consts, 4,
        StageGraphs(None), "edge", torch.bfloat16)
    assert seconds > 0
    layers = ARCHS["production"]["denoiser"]["num_layers"]
    assert launches["packed_attention"] == layers
    # K7: two norms a layer, the final norm, the five streams' embedders, the
    # time embedding's and the head's
    assert launches["add_layer_norm"] == 2 * layers + 1 + 5 + 2
    assert all(n == 0 for k, n in launches.items()
               if k not in ("packed_attention", "add_layer_norm"))
