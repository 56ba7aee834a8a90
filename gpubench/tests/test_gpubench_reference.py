"""The reference against the program's plain path, at the small
architecture on the CPU, in float32: the denoisers, the samplers, dedup, the
VAEs, the optimizer and the point-cloud metrics agree to rounding."""

import numpy as np
import pytest
import torch

from gpubench.kinds.common import SMALL, build
from gpubench.reference import dedup as rd
from gpubench.reference import denoiser as rn
from gpubench.reference import metrics as rm
from gpubench.reference import schedulers as rs
from gpubench.reference import train as rt
from gpubench.reference import vae as rv

CPU = torch.device("cpu")
DEN = SMALL["denoiser"]


def gap(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm().clamp(min=1e-30))


@pytest.mark.parametrize("stage", ["surfpos", "surfz", "edgepos", "edgez"])
def test_denoiser(stage):
    from brepgen_tpu_torch.cli.build import build_denoiser

    mods, p = build({stage: lambda: build_denoiser(stage, False, **DEN)}, 7, CPU)
    gen = torch.Generator().manual_seed(1)
    S = 12
    streams = {n: torch.randn(3, S, rn.STREAM_DIMS[n], generator=gen) for n in rn.STREAMS[stage]}
    pad = torch.rand(3, S, generator=gen) < 0.3
    pad[:, 0] = False
    t = torch.tensor([3, 500, 999])
    with torch.no_grad():
        got = mods[stage]([streams[n] for n in rn.STREAMS[stage]], t, pad)
    want = rn.denoise(p[stage], stage, streams, t, pad, DEN["num_heads"], DEN["num_layers"])
    assert gap(got, want) < 1e-5


def _eps(x, t):
    return torch.tanh(x) * 0.7 + t / 1000.0


def test_samplers():
    from brepgen_tpu_torch.diffusion import (ddim_loop, ddpm_loop, make_ddim_plan,
                                             make_ddpm_plan, make_pndm_plan, pndm_loop,
                                             slice_plan)

    x = torch.randn(2, 5, 6, generator=torch.Generator().manual_seed(2))
    noise = {i: torch.randn(2, 5, 6, generator=torch.Generator().manual_seed(10 + i))
             for i in range(250)}
    got = pndm_loop(_eps, x, make_pndm_plan(200, max_calls=158))
    assert gap(got, rs.pndm(_eps, x, 200, 158)) < 1e-5
    got = pndm_loop(_eps, x, make_pndm_plan(200))
    assert gap(got, rs.pndm(_eps, x, 200)) < 1e-5
    got = ddpm_loop(_eps, x, make_ddpm_plan(250), lambda i, s: noise[i], 3.0)
    assert gap(got, rs.ddpm(_eps, x, 250, lambda i, s: noise[i], 3.0)) < 1e-5
    plan = make_ddim_plan(50)
    assert gap(ddim_loop(_eps, x, plan), rs.ddim(_eps, x, 50)) < 1e-5
    got = ddim_loop(_eps, x, slice_plan(plan, 37), clip_range=3.0)
    assert gap(got, rs.ddim(_eps, x, 50, calls=37, clip=3.0)) < 1e-5
    assert int(plan.t[36]) == int(rs.ddim_timesteps(50)[36])


def test_dedup():
    from brepgen_tpu_torch.sampling.dedup import dedup_bboxes, dedup_edges_per_face

    gen = torch.Generator().manual_seed(3)
    boxes = torch.randn(4, 20, 6, generator=gen)
    boxes[:, 5] = boxes[:, 2] + 0.01                     # near duplicates
    boxes[:, 9] = boxes[:, 1][:, [3, 4, 5, 0, 1, 2]]     # corners swapped
    keep = rd.keep_boxes(boxes, 0.08)
    assert torch.equal(keep, dedup_bboxes(boxes, 0.08)) and not keep[:, 5].any()
    edges = torch.randn(4, 20, 7, 6, generator=gen)
    edges[:, :, 3] = edges[:, :, 0]
    assert torch.equal(rd.keep_edges(edges, keep, 0.08), dedup_edges_per_face(edges, keep, 0.08))


def test_vaes():
    from brepgen_tpu_torch.nn import EdgeVAE, SurfVAE

    sc, ec = SMALL["surface_vae"], SMALL["edge_vae"]
    mods, p = build({"s": lambda: SurfVAE(block_out_channels=tuple(sc)),
                     "e": lambda: EdgeVAE(block_out_channels=tuple(ec))}, 9, CPU)
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        z = torch.randn(3, 4, 4, 3, generator=gen)
        assert gap(mods["s"].decode(z), rv.surf_decode(p["s"], z, sc)) < 1e-5
        z = torch.randn(3, 4, 3, generator=gen)
        assert gap(mods["e"].decode(z), rv.edge_decode(p["e"], z, ec)) < 1e-5
        g = torch.randn(3, 32, 32, 3, generator=gen)
        assert gap(mods["s"].encode(g).mode(), rv.surf_encode(p["s"], g, sc)) < 1e-5
        g = torch.randn(3, 32, 3, generator=gen)
        assert gap(mods["e"].encode(g).mode(), rv.edge_encode(p["e"], g, ec)) < 1e-5


@pytest.mark.parametrize("clip", [50.0, 1e-3])
def test_optimizer(clip):
    from brepgen_tpu_torch.train.common import make_ldm_optimizer

    gen = torch.Generator().manual_seed(5)
    params = {"a": torch.randn(4, 3, generator=gen), "b": torch.randn(7, generator=gen)}
    live = [torch.nn.Parameter(v.clone()) for v in params.values()]
    opt = make_ldm_optimizer(live, clip=clip)
    ref = rt.AdamW(params, 5e-4, (0.95, 0.999), 1e-8, 1e-6, clip)
    for step in range(3):
        grads = {k: torch.randn(v.shape, generator=gen) for k, v in params.items()}
        for p, g in zip(live, grads.values()):
            p.grad = g.clone()
        opt.step()
        ref.step(grads)
    for p, k in zip(live, params):
        assert gap(p.detach() - params[k], ref.p[k] - params[k]) < 1e-5


def test_optimizer_from_a_state():
    """Started from the program's moments and count after two steps, the
    reference's next two steps follow the program's."""
    from brepgen_tpu_torch.train.common import make_ldm_optimizer

    gen = torch.Generator().manual_seed(7)
    params = {"a": torch.randn(4, 3, generator=gen), "b": torch.randn(7, generator=gen)}
    live = [torch.nn.Parameter(v.clone()) for v in params.values()]
    opt = make_ldm_optimizer(live, clip=50.0)

    def step_program():
        grads = {k: torch.randn(v.shape, generator=gen) for k, v in params.items()}
        for p, g in zip(live, grads.values()):
            p.grad = g.clone()
        opt.step()
        return grads

    for _ in range(2):
        step_program()
    state = [opt.adamw.state[p] for p in live]
    start = {k: p.detach().clone() for k, p in zip(params, live)}
    ref = rt.AdamW(start, 5e-4, (0.95, 0.999), 1e-8, 1e-6, 50.0,
                   state=({k: s["exp_avg"] for k, s in zip(params, state)},
                          {k: s["exp_avg_sq"] for k, s in zip(params, state)},
                          int(state[0]["step"])))
    m0 = {k: s["exp_avg"].clone() for k, s in zip(params, state)}
    for k in range(2):
        grads = step_program()
        ref.step(grads)
        if k == 0:
            for key, s in zip(params, state):  # the gradient, from the first moment
                g = (s["exp_avg"] - 0.95 * m0[key]) / 0.05
                assert gap(g, ref.first[key]) < 1e-5 and gap(g, grads[key]) < 1e-5
    for p, k in zip(live, params):
        assert gap(p.detach() - start[k], ref.p[k] - start[k]) < 1e-5


def test_point_cloud_metrics():
    from brepgen_tpu_torch.eval.metrics import cov_mmd_from_matrix, jsd_between_point_cloud_sets
    from brepgen_tpu_torch.kernels.chamfer import chamfer_matrix_reference

    gen = torch.Generator().manual_seed(6)
    x = torch.rand(5, 40, 3, generator=gen) * 2 - 1
    y = torch.rand(4, 40, 3, generator=gen) * 2 - 1
    d = rm.chamfer_rows(x, y)
    assert gap(d, chamfer_matrix_reference(x, y)) < 1e-6
    got, want = cov_mmd_from_matrix(d.numpy()), rm.cov_mmd(d.numpy())
    assert abs(got["MMD-CD"] - want["MMD-CD"]) < 1e-7 and got["COV-CD"] == want["COV-CD"]
    assert abs(jsd_between_point_cloud_sets(x.numpy(), y.numpy())
               - rm.jsd(x.numpy(), y.numpy())) < 1e-12
    assert 1e-5 < gap(rm.chamfer_rows(x, y, "tf32"), d) < 0.5  # the control: TF32's rounding


@pytest.mark.parametrize("workload,overrides,names", [
    ("deepcad-train", {"training": {"dtype": "float32"}}, ("loss_gap", "grad_gap", "update_gap")),
    ("abc-sample-ddim50", {"sampling": {"dtype": "float32", "batch_size": 2,
                                        "num_surfaces": 4, "num_edges": 3},
                           "mix": {"fast_steps": 6, "check_calls": 2}},
     ("denoiser_gap", "scheduler_gap", "decode_gap")),
])
def test_the_program_in_f32_reads_rounding(workload, overrides, names):
    """With the configuration's type set to f32 the program's readings are
    of rounding alone: the whole check (draws, dropout masks, encodes,
    samplers, optimizer) follows the program."""
    from gpubench import control

    r = control.readings(workload, 2147483659, 0.05, "cpu", overrides)
    for n in names:
        assert r["program"][n] < 1e-4, (n, r)
    assert np.isfinite(list(r["control"].values())).all()
