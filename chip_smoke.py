#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on the card.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``brepgen_tpu_torch/kernels/csrc`` with
nvcc, holds each against its plain PyTorch version on the card, drives the
deepcad sampling cascade at the production width through the port's own entry
points (seeded weights, DDIM fast mode) after a small cascade on the card
against the same one on the CPU, drives the default PNDM + DDPM
protocol on the committed all160k packs, and checks shapes, finiteness, masks
and kernel launch counts. Each phase prints one line with its seconds. The
last lines are one JSON object of kernel measurements and the result line.
Any failure raises and exits non-zero; without a CUDA card it exits 1 and
prints no result. It imports torch, numpy and ``brepgen_tpu_torch`` only.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.abspath(__file__))
PACKS = os.path.join(ROOT, "artifacts", "demo_round5", "all160k", "ckpt_packed")

# Peak rates of one H100 SXM (NVIDIA data sheet, dense, at 700 W) for bound_ms.
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
# |kernel - plain| <= REL * |plain| + ABS per element, the plain version run in
# f32 on the same (for bf16: bf16-valued) inputs. A bf16 output is one
# rounding (relative 2^-9) from the f32 result. MAX_ABS bounds the max
# absolute error over the whole output.
REL = {"float32": 0.0, "bfloat16": 2.0 ** -8}
ABS = 1e-4
MAX_ABS = {"float32": 1e-4, "bfloat16": 2e-2}
KERNEL_SHAPES = ((16, 1800, 768, 12), (4, 1800, 256, 8))  # (B, S, W, H)


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:8.2f} s] {msg}", flush=True)


def make_masks(torch, B: int, S: int, gen) -> "torch.Tensor":
    """Ragged key-padding masks (True = pad): no padding, only slot 0 kept,
    every key masked, a suffix of 37, and random masks of growing density
    with slot 0 kept."""
    mask = torch.rand((B, S), generator=gen, device="cuda") < torch.linspace(
        0.05, 0.95, B, device="cuda")[:, None]
    mask[:, 0] = False
    mask[0] = False
    mask[1] = True
    mask[1, 0] = False
    mask[2] = True
    if B > 3:
        mask[3] = False
        mask[3, S - 37:] = True
    return mask


def time_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def attention_bound(B, S, W, dtype_name, itemsize):
    flops = 4.0 * B * S * S * W
    nbytes = B * S * 3 * W * itemsize + B * S + B * S * W * itemsize
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype_name] * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_kernel(torch, results):
    import torch.nn.functional as F

    from brepgen_tpu_torch.kernels.attention import packed_attention, packed_attention_reference

    gen = torch.Generator(device="cuda").manual_seed(0)
    for B, S, W, H in KERNEL_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            qkv = torch.randn((B, S, 3 * W), generator=gen, device="cuda").to(dtype)
            mask = make_masks(torch, B, S, gen)
            got = packed_attention(qkv, H, mask).float()
            want = packed_attention_reference(qkv.float(), H, mask)
            # an all-masked row must be the uniform mean of V over the S keys
            want_uniform = qkv[2, :, 2 * W:].float().mean(0).expand(S, W)
            diff = (got - want).abs()
            over = diff - (REL[name] * want.abs() + ABS)
            over_uniform = (got[2] - want_uniform).abs() - (REL[name] * want_uniform.abs() + ABS)
            err = diff.max().item()
            # rows by the number of keys they attend to: many, one (slot 0), none
            keys = (~mask).sum(1)
            row_err = diff.amax(dim=(1, 2))
            errs = {k: row_err[sel].max().item() for k, sel in
                    (("dense", keys > 1), ("one-key", keys == 1), ("all-masked", keys == 0))}
            dense_mag = want[keys > 1].abs().mean().item()
            tol = f"|err| <= {REL[name]:g}*|plain| + {ABS:g}, max {MAX_ABS[name]:g}"
            if over.max().item() > 0 or over_uniform.max().item() > 0 or err > MAX_ABS[name]:
                raise AssertionError(
                    f"packed_attention B={B} S={S} W={W} H={H} {name}: max_abs_err {err:.3e} "
                    f"(rows {errs}), against the uniform mean on the all-masked row "
                    f"{over_uniform.max().item():.3e} over its bound; tolerance {tol}")
            D = W // H
            q, k, v = (a.reshape(B, S, H, D).transpose(1, 2) for a in qkv.split(W, dim=-1))
            bias = torch.where(mask[:, None, None, :], -1e9, 0.0).to(dtype)
            reps = 20 if B * S * W > 4e6 else 50
            ms = time_ms(torch, lambda: packed_attention(qkv, H, mask), reps)
            plain_ms = time_ms(torch, lambda: packed_attention_reference(qkv, H, mask), 5)
            lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=bias), 5)
            bound_ms, bound_by = attention_bound(B, S, W, name, qkv.element_size())
            results.append(dict(B=B, S=S, W=W, H=H, dtype=name, max_abs_err=err,
                                row_max_abs_err=errs, ms=ms, plain_ms=plain_ms,
                                library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by))
            log(f"kernel packed_attention B={B} S={S} W={W} H={H} {name}: "
                f"max_abs_err {err:.3e}; by rows: dense {errs['dense']:.3e} (mean |out| "
                f"{dense_mag:.3e}), one-key {errs['one-key']:.3e}, all-masked "
                f"{errs['all-masked']:.3e}; tolerance {tol}; "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, "
                f"bound {bound_ms:.4f} ms ({bound_by})")
            del qkv, got, want, diff, over, q, k, v, bias
    torch.cuda.empty_cache()


class CpuNoise:
    """N(0, 1) draws from a CPU generator, moved to ``device``: the same
    numbers whatever the device."""

    def __init__(self, torch, device):
        self.torch, self.device = torch, device
        self.gen = torch.Generator().manual_seed(1)

    def __call__(self, site, shape, step=None):
        return self.torch.randn(tuple(shape), generator=self.gen).to(self.device)


def phase_small(torch):
    """A small cascade (width 64, 2 heads, 2 layers) on the card through the
    kernel against the same cascade on the CPU through the plain version."""
    from brepgen_tpu_torch import nn as tnn
    from brepgen_tpu_torch.cli.build import build_denoiser, seed_weights
    from brepgen_tpu_torch.sampling import Cascade, CascadeConfig

    cfg = CascadeConfig(batch_size=2, num_surfaces=6, num_edges=5, pndm_steps=20,
                        pos_pndm_calls=16, ddpm_tail=10)
    arch = dict(width=64, num_heads=2, ffn_width=128, num_layers=2)
    outs = {}
    for device in ("cpu", "cuda"):
        gen = torch.Generator().manual_seed(0)
        nets = {s: seed_weights(build_denoiser(s, arch="demo", **arch), gen).to(device).eval()
                for s in ("surfpos", "surfz", "edgepos", "edgez")}
        vaes = [seed_weights(m, gen).to(device).eval()
                for m in (tnn.SurfVAE((8, 8, 8, 8)), tnn.EdgeVAE((8, 8, 8)))]
        out = Cascade(nets, *vaes, cfg)(CpuNoise(torch, device))
        outs[device] = {k: v.cpu() for k, v in out.items()}
    # f32 on two devices: summation orders differ through 160 denoiser calls
    tol = 1e-3
    for k, want in outs["cpu"].items():
        got = outs["cuda"][k]
        if want.dtype == torch.bool:
            if not torch.equal(got, want):
                raise AssertionError(f"small cascade: {k} differs between card and CPU")
        else:
            err = (got - want).abs().max().item()
            if not err <= tol:
                raise AssertionError(f"small cascade: {k} max abs diff {err:.3e} > {tol:g}")
    err = max((outs["cuda"][k] - v).abs().max().item() for k, v in outs["cpu"].items()
              if v.dtype != torch.bool)
    log(f"small cascade (B=2, ns=12, ne=5, width 64, PNDM 20): card through the kernel "
        f"against CPU through the plain version: masks equal, max abs diff {err:.3e} "
        f"(tolerance {tol:g})")


def check_batch(np, out, B, ns, ne):
    shapes = {
        "surf_pos": (B, ns, 6), "surf_mask": (B, ns), "surf_z": (B, ns, 48),
        "surf_ncs": (B, ns, 32, 32, 3), "edge_pos": (B, ns, ne, 6), "edge_mask": (B, ns, ne),
        "edge_z": (B, ns, ne, 12), "edge_v": (B, ns, ne, 6), "edge_ncs": (B, ns, ne, 32, 3),
    }
    for k, shape in shapes.items():
        if out[k].shape != shape:
            raise AssertionError(f"{k}: shape {out[k].shape}, expected {shape}")
        if out[k].dtype != bool and not np.isfinite(out[k]).all():
            raise AssertionError(f"{k}: non-finite values")
    surf_keep = ~out["surf_mask"]
    edge_keep = ~out["edge_mask"]
    if not surf_keep[:, 0].all():
        raise AssertionError("face slot 0 dropped")
    if not (edge_keep[:, :, 0] == surf_keep).all():
        raise AssertionError("edge slot 0 of a kept face dropped, or an edge of a dropped face kept")
    if (out["edge_z"][out["edge_mask"]] != 0).any():
        raise AssertionError("masked edge latents are not zero")
    return int(surf_keep.sum()), int(edge_keep.sum())


def drive(torch, np, label, cascade, expected_edge_calls):
    """Run one batch through the user's entry point; check it and the counts."""
    from brepgen_tpu_torch.cli.sample_main import sample_loop
    from brepgen_tpu_torch.kernels import LAUNCH_COUNTS, reset_launch_counts

    cfg = cascade.cfg
    net = cascade.nets["edgez"]
    layers = net.encoder.num_layers
    after = {}
    stage_times = {}
    with tempfile.TemporaryDirectory() as tmp:
        reset_launch_counts()
        t0 = time.perf_counter()
        batches = sample_loop(cascade, max_batches=1, seed=0, save_folder=tmp,
                              stage_times=stage_times,
                              after_stage=lambda s: after.__setitem__(s, LAUNCH_COUNTS["packed_attention"]))
        seconds = time.perf_counter() - t0
        launches = LAUNCH_COUNTS["packed_attention"]
        with np.load(os.path.join(tmp, "batches.npz")) as saved:
            if sorted(saved.files) != sorted(f"{k}__0" for k in batches[0]):
                raise AssertionError(f"batches.npz keys {saved.files}")
    faces, edges = check_batch(np, batches[0], cfg.batch_size, cfg.faces, cfg.num_edges)
    calls = cascade.model_calls
    edge_calls = calls["edgepos"] + calls["edgez"]
    if edge_calls != expected_edge_calls:
        raise AssertionError(f"{label}: {edge_calls} edge-stage calls, expected {expected_edge_calls}")
    if after["surfz"] != 0:
        raise AssertionError(f"{label}: surf stages launched the kernel {after['surfz']} times")
    if launches != layers * edge_calls or after["edgez"] != launches:
        raise AssertionError(f"{label}: {launches} kernel launches, expected "
                             f"{layers} x {edge_calls} edge-stage calls")
    log(f"{label}: B={cfg.batch_size} ns={cfg.faces} ne={cfg.num_edges} "
        f"S={cfg.faces * cfg.num_edges}; model calls {calls}; packed_attention launches "
        f"{launches} = {layers} layers x {edge_calls} edge calls (surf stages 0); kept "
        f"{faces} faces, {edges} edges; stage seconds "
        + ", ".join(f"{k} {v:.2f}" for k, v in stage_times.items())
        + f"; total {seconds:.2f} s")
    return dict(path=label, B=cfg.batch_size, S=cfg.faces * cfg.num_edges, W=net.width,
                H=net.encoder.layer_0.attn.num_heads, dtype=str(net.dtype).split(".")[-1],
                launches=launches, seconds=seconds)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    # full f32 in matrix products and convolutions, as the CPU reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from brepgen_tpu_torch.cli.sample_main import init_cascade
    from brepgen_tpu_torch.diffusion import make_pndm_plan
    from brepgen_tpu_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t = time.perf_counter()
    _build.load("packed_attention")
    build_s = time.perf_counter() - t
    ptxas = [ln.strip() for ln in _build.BUILD_LOG.get("packed_attention", (0, ""))[1].splitlines()
             if "registers" in ln or "spill" in ln or "entry function" in ln]
    log(f"env: python {sys.version.split()[0]}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, card {torch.cuda.get_device_name(0)} ({smi}), "
        f"{torch.cuda.device_count()} visible; packed_attention built in {build_s:.2f} s")
    for ln in ptxas:
        log(f"  ptxas: {ln}")

    results = []
    t = time.perf_counter()
    phase_kernel(torch, results)
    log(f"phase kernel done in {time.perf_counter() - t:.2f} s")

    t = time.perf_counter()
    phase_small(torch)
    log(f"phase small done in {time.perf_counter() - t:.2f} s")

    t = time.perf_counter()
    fast = 50
    cascade = init_cascade("deepcad", seed=0, batch_size=16, device="cuda",
                           step_overrides={"fast_steps": fast})
    log(f"cascade: production weights seeded in {time.perf_counter() - t:.2f} s")
    paths = [drive(torch, np, "cascade (production width, seeded, DDIM 50)", cascade, 2 * fast)]
    del cascade
    torch.cuda.empty_cache()
    log(f"phase cascade done in {time.perf_counter() - t:.2f} s")

    t = time.perf_counter()
    cascade = init_cascade("deepcad", PACKS, batch_size=4, device="cuda")
    log(f"protocol: all160k packs loaded in {time.perf_counter() - t:.2f} s")
    cfg = cascade.cfg
    expected = cfg.pos_pndm_calls + cfg.ddpm_tail + len(make_pndm_plan(cfg.pndm_steps).t_model)
    paths.append(drive(torch, np, "protocol (all160k packs, PNDM + DDPM)", cascade, expected))
    log(f"phase protocol done in {time.perf_counter() - t:.2f} s")

    # the top-level numbers are those of the full-width shape in f32 and its
    # cascade run; "shapes" has every measured shape, "paths" every driven run
    main_shape = results[0]
    print(json.dumps({"kernels": [{
        "name": "packed_attention",
        "route": "cuda",
        "source": "brepgen_tpu_torch/kernels/csrc/packed_attention.cu",
        "replaces": "brepgen_tpu/kernels/attention.py:150",
        "launches": paths[0]["launches"],
        "max_abs_err": main_shape["max_abs_err"],
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": main_shape["library_ms"],
        "shapes": results,
        "paths": paths,
    }]}), flush=True)
    log(f"all phases passed in {time.perf_counter() - T0:.2f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
