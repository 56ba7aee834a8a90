#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on the card.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py [--seed N]

It builds the port's CUDA kernels from ``brepgen_tpu_torch/kernels/csrc`` with
nvcc (one nvcc per source, started together) and holds each attention entry
(K1 packed, K3 per-head, K2 long-set), the Chamfer kernel and the packed
attention's backward (K5) against its plain PyTorch version on the card. After a small cascade on the card against
the same one on the CPU it drives the port's own entry points: the deepcad
and abc cascades at the production width (seeded weights, DDIM fast mode;
abc in f32 takes the per-head kernel), abc on the committed all160k packs
without and with face-token compaction, a long set of 8400 tokens through
the sample CLI's ``--config`` (the long-set kernel), the default PNDM + DDPM
protocol on the all160k packs with host postprocess overlapping the cascade
(STEP + STL), one batch post-processed serially, and point clouds from the
solids scored against reference clouds drawn from ``--seed`` through the
Chamfer kernel; then the training CLI trains the edgez denoiser at the
production width in bf16 (K1 forward and K5 backward in every layer of every
step), its pack is reloaded, and one f32 step through the kernels is held
against the same step through plain attention. It checks shapes,
finiteness, masks, solids, agreement of the compacted and full runs, the
gradients, and kernel launch counts. Each
phase prints one line with its seconds. The last lines are one JSON object
of kernel measurements and the result line. Any failure raises and exits
non-zero; without a CUDA card it exits 1 and prints no result. It imports
torch, numpy and ``brepgen_tpu_torch`` only.
"""

from __future__ import annotations

import argparse
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
# (B, S, W, H): K1 at the deepcad edge stages (ns x ne = 60 x 30), K3 at ABC
# (100 x 40), K2 at the long set of phase long set (140 x 60); production and
# demo widths each
KERNEL_SHAPES = ((16, 1800, 768, 12), (4, 1800, 256, 8))
K3_SHAPES = ((16, 4000, 768, 12), (4, 4000, 256, 8))
K2_SHAPES = ((2, 8400, 768, 12), (4, 8400, 256, 8))
DEEPCAD_STEPS, ABC_STEPS, LONG_STEPS = 25, 10, 4  # DDIM steps per stage of the seeded paths
# Compacted against uncompacted abc on the card: the same kernels over other
# key tiles and matrix shapes, so f32 sums in another order through 20
# denoiser calls (the small cascade's bar between card and CPU)
COMPACT_TOL = 1e-3
# Chamfer matrix: (S, R, P, n_pts); the first is the n=256 eval protocol
CHAMFER_SHAPES = ((256, 256, 2000, 2000), (37, 13, 300, 300), (37, 13, 300, 257))
CHAMFER_PROTOCOL = (3000, 1000, 2000)  # one repeat of the eval protocol, timed
# |kernel - plain| <= CHAMFER_REL * |plain| + CHAMFER_ABS per element: the
# kernel fuses multiply-adds and sums its means in another order (~1e-7 rel)
CHAMFER_REL, CHAMFER_ABS = 1e-5, 1e-7
# K5, the packed attention's backward: (B, S, W, H) at the deepcad edgez
# training shape (train_ldm.sh: batch 128, 30 faces x 20 edges) and at a demo
# width; held per element to its plain version in f32 with the forward's
# REL/ABS bars. Not to MAX_ABS: a gradient sums over S rows (dV of the one key
# of a one-key sample is the sum of 600 rows of dO, about 60), so its bf16
# rounding alone exceeds 2e-2.
K5_SHAPES = ((128, 600, 768, 12), (64, 160, 256, 8))
# Phase train: the CLI trains edgez at production width in bf16 on synthetic
# solids at the deepcad training shape (train_ldm.sh:21-25), one step per
# epoch (256 solids, batch 128, drop_last), one validation pass at the end
TRAIN_EPOCHS = 6
TRAIN_ARGS = ("--option", "edgez", "--bf16", "--max_face", "30", "--max_edge", "20",
              "--batch_size", "128", "--synthetic", "256", "--num_workers", "0")
# The same f32 edgez step through the kernels and through plain attention:
# the difference of all gradients within GRAD_REL of their norm. Not per
# element: the two forwards differ by about 1e-7, which flips the ReLU of
# pre-activations near zero, so single gradient elements of the FFN weights
# move by a token's whole contribution (measured 7e-3 of a tensor's largest
# gradient, global relative difference 2.0e-4, at B=16 on the H100)
GRAD_BATCH = 16
GRAD_REL = 1e-3


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:8.2f} s] {msg}", flush=True)


def make_masks(torch, B: int, S: int, gen) -> "torch.Tensor":
    """Ragged key-padding masks (True = pad): no padding, only slot 0 kept,
    every key masked (from B = 3), a suffix of 37 (from B = 4), and random
    masks of growing density with slot 0 kept."""
    mask = torch.rand((B, S), generator=gen, device="cuda") < torch.linspace(
        0.05, 0.95, B, device="cuda")[:, None]
    mask[:, 0] = False
    mask[0] = False
    mask[1] = True
    mask[1, 0] = False
    if B > 2:
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


def hold_to_plain(torch, label, got, want, qkv, mask, W, name):
    """Hold a kernel's [B, S, W] output per element to its plain version in
    f32, and its all-masked sample 2 (where B > 2) to the uniform mean of V;
    raise past the bars. Returns (max abs err, max abs err by rows, text)."""
    B, S = got.shape[:2]
    diff = (got - want).abs()
    over = diff - (REL[name] * want.abs() + ABS)
    over_uniform = torch.zeros(1, device=got.device)
    if B > 2:
        want_uniform = qkv[2, :, 2 * W:].float().mean(0).expand(S, W)
        over_uniform = (got[2] - want_uniform).abs() - (REL[name] * want_uniform.abs() + ABS)
    err = diff.max().item()
    # rows by the number of keys they attend to: many, one (slot 0), none
    keys = (~mask).sum(1)
    row_err = diff.amax(dim=(1, 2))
    errs = {k: row_err[sel].max().item() for k, sel in
            (("dense", keys > 1), ("one-key", keys == 1), ("all-masked", keys == 0))
            if sel.any()}
    tol = f"|err| <= {REL[name]:g}*|plain| + {ABS:g}, max {MAX_ABS[name]:g}"
    if over.max().item() > 0 or over_uniform.max().item() > 0 or err > MAX_ABS[name]:
        raise AssertionError(
            f"{label} {name}: max_abs_err {err:.3e} (rows {errs}), against the uniform mean "
            f"on the all-masked row {over_uniform.max().item():.3e} over its bound; "
            f"tolerance {tol}")
    dense_mag = want[keys > 1].abs().mean().item()
    text = (f"max_abs_err {err:.3e}; by rows: "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
            + f" (dense mean |out| {dense_mag:.3e}); tolerance {tol}")
    return err, errs, text


def split_heads(qkv, H):
    """q, k, v [B, H, S, D] views of qkv [B, S, 3W]."""
    B, S, W3 = qkv.shape
    return (a.reshape(B, S, H, W3 // 3 // H).transpose(1, 2) for a in qkv.split(W3 // 3, dim=-1))


def phase_attention(torch, kernel, shapes, results):
    """One attention kernel against its plain version at ``shapes`` (B, S, W,
    H) in f32 and bf16, timed beside the plain version, SDPA and, for K3
    and K2, K1 on the same inputs."""
    import torch.nn.functional as F

    from brepgen_tpu_torch.kernels.attention import (
        packed_attention,
        packed_attention_reference,
        packed_flash_attention,
        packed_flash_attention_reference,
    )
    from brepgen_tpu_torch.kernels.set_attention import set_attention, set_attention_reference

    def per_head(fn):
        def run(qkv, H, mask):
            B, S, W3 = qkv.shape
            q, k, v = (a.contiguous() for a in split_heads(qkv, H))
            return fn(q, k, v, mask).transpose(1, 2).reshape(B, S, W3 // 3)
        return run

    fns = {
        "packed_attention": (packed_attention, packed_attention_reference),
        "packed_flash_attention": (packed_flash_attention, packed_flash_attention_reference),
        "set_attention": (per_head(set_attention), per_head(set_attention_reference)),
    }
    run_kernel, run_plain = fns[kernel]
    gen = torch.Generator(device="cuda").manual_seed(0)
    for B, S, W, H in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            qkv = torch.randn((B, S, 3 * W), generator=gen, device="cuda").to(dtype)
            mask = make_masks(torch, B, S, gen)
            label = f"kernel {kernel} B={B} S={S} W={W} H={H}"
            got = run_kernel(qkv, H, mask).float()
            want = run_plain(qkv.float(), H, mask)
            err, errs, text = hold_to_plain(torch, label, got, want, qkv, mask, W, name)
            del got, want
            torch.cuda.empty_cache()
            row = dict(B=B, S=S, W=W, H=H, dtype=name, max_abs_err=err, row_max_abs_err=errs)
            reps = 20 if B * S * W > 4e6 else 50
            if kernel == "set_attention":
                # the kernel alone, on the split heads the transformer hands it
                q, k, v = (a.contiguous() for a in split_heads(qkv, H))
                row["ms"] = time_ms(torch, lambda: set_attention(q, k, v, mask), reps)
                del q, k, v
            else:
                row["ms"] = time_ms(torch, lambda: run_kernel(qkv, H, mask), reps)
            row["plain_ms"] = time_ms(torch, lambda: run_plain(qkv, H, mask), 3)
            q, k, v = split_heads(qkv, H)
            bias = torch.where(mask[:, None, None, :], -1e9, 0.0).to(dtype)
            row["library_ms"] = time_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=bias), 3)
            del q, k, v, bias
            if kernel != "packed_attention":
                row["packed_attention_ms"] = time_ms(
                    torch, lambda: packed_attention(qkv, H, mask), reps)
            row["bound_ms"], row["bound_by"] = attention_bound(B, S, W, name, qkv.element_size())
            results.append(row)
            k1 = (f", K1 {row['packed_attention_ms']:.4f} ms" if "packed_attention_ms" in row
                  else "")
            log(f"{label} {name}: {text}; kernel {row['ms']:.4f} ms, plain "
                f"{row['plain_ms']:.4f} ms, sdpa {row['library_ms']:.4f} ms{k1}, bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
            del qkv, mask
            torch.cuda.empty_cache()


def backward_bound(B, S, W, dtype_name, itemsize):
    """The five products of the backward (dV, dP, dQ, dK and the logits
    recomputed), 10*B*S^2*W operations, against qkv and dO read once and
    dqkv written once."""
    flops = 10.0 * B * S * S * W
    nbytes = B * S * 7 * W * itemsize + B * S
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype_name] * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_backward(torch, results):
    """K5 against its plain version at ``K5_SHAPES`` in f32 and bf16, timed
    beside the plain version, the SDPA backward (torch.autograd.grad through
    scaled_dot_product_attention with the -1e9 float mask; its forward runs
    outside the timed region) and K1's forward on the same inputs."""
    import torch.nn.functional as F

    from brepgen_tpu_torch.kernels.attention import (
        packed_attention,
        packed_attention_backward,
        packed_attention_backward_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(5)
    for B, S, W, H in K5_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            qkv = torch.randn((B, S, 3 * W), generator=gen, device="cuda").to(dtype)
            dout = torch.randn((B, S, W), generator=gen, device="cuda").to(dtype)
            mask = make_masks(torch, B, S, gen)
            label = f"kernel packed_attention_backward B={B} S={S} W={W} H={H}"
            got = packed_attention_backward(qkv, dout, H, mask).float()
            want = packed_attention_backward_reference(qkv.float(), dout.float(), H, mask)
            diff = (got - want).abs()
            err = diff.max().item()
            over = (diff - (REL[name] * want.abs() + ABS)).max().item()
            keys = (~mask).sum(1)
            row_err = diff.amax(dim=(1, 2))
            errs = {k: row_err[sel].max().item() for k, sel in
                    (("dense", keys > 1), ("one-key", keys == 1), ("all-masked", keys == 0))
                    if sel.any()}
            tol = f"|err| <= {REL[name]:g}*|plain| + {ABS:g}"
            if over > 0 or not torch.isfinite(got).all():
                raise AssertionError(f"{label} {name}: max_abs_err {err:.3e} (rows {errs}), "
                                     f"{over:.3e} over the bound; tolerance {tol}")
            mag = want.abs().mean().item()
            del got, want, diff
            torch.cuda.empty_cache()
            row = dict(B=B, S=S, W=W, H=H, dtype=name, max_abs_err=err, row_max_abs_err=errs)
            row["ms"] = time_ms(torch, lambda: packed_attention_backward(qkv, dout, H, mask), 10)
            row["plain_ms"] = time_ms(torch, lambda: packed_attention_backward_reference(
                qkv, dout, H, mask), 2)
            q, k, v = (a.detach().requires_grad_() for a in split_heads(qkv, H))
            g = dout.reshape(B, S, H, W // H).transpose(1, 2)
            bias = torch.where(mask[:, None, None, :], -1e9, 0.0).to(dtype)
            out = F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
            row["library_ms"] = time_ms(torch, lambda: torch.autograd.grad(
                out, (q, k, v), g, retain_graph=True), 3)
            del q, k, v, g, bias, out
            with torch.no_grad():
                row["packed_attention_ms"] = time_ms(
                    torch, lambda: packed_attention(qkv, H, mask), 10)
            row["bound_ms"], row["bound_by"] = backward_bound(B, S, W, name, qkv.element_size())
            results.append(row)
            log(f"{label} {name}: max_abs_err {err:.3e} (mean |plain| {mag:.3e}); by rows: "
                + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
                + f"; tolerance {tol}; kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} "
                f"ms, sdpa backward {row['library_ms']:.4f} ms, K1 forward "
                f"{row['packed_attention_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
                f"({row['bound_by']})")
            del qkv, dout, mask
            torch.cuda.empty_cache()


class GradCapture:
    """An optimizer stand-in for one step: keeps the gradients."""

    def __init__(self, module):
        self.module, self.grads = module, None

    def step(self):
        self.grads = {k: p.grad.detach().clone() for k, p in self.module.named_parameters()
                      if p.grad is not None}
        self.module.zero_grad(set_to_none=True)


def phase_train(torch, np, work):
    """The training CLI (``ldm_main``) on edgez at production width in bf16:
    K5 once per layer of every step, K1 twice (forward and the recompute of
    remat) and once per layer of every validation call; the written pack
    reloads strictly with the same forward; then one f32 step through the
    kernels against the same step through plain attention."""
    from brepgen_tpu_torch.cli import ldm_main
    from brepgen_tpu_torch.cli.build import build_denoiser, seed_weights
    from brepgen_tpu_torch.data.batch_assembly import assemble_edgez_batched
    from brepgen_tpu_torch.data.synthetic import make_dataset
    from brepgen_tpu_torch.diffusion.ddpm import make_ddpm_tables
    from brepgen_tpu_torch.kernels import LAUNCH_COUNTS, reset_launch_counts
    from brepgen_tpu_torch.train import ldm_train
    from brepgen_tpu_torch.train.checkpoint import load_params
    from brepgen_tpu_torch.train.common import TrainState
    from brepgen_tpu_torch.train.vae_train import make_encoder_fn

    e = str(TRAIN_EPOCHS)
    argv = [*TRAIN_ARGS, "--surfvae", os.path.join(PACKS, "surf_vae.npz"),
            "--edgevae", os.path.join(PACKS, "edge_vae.npz"), "--train_nepoch", e,
            "--test_nepoch", e, "--save_nepoch", e, "--dir_name", work, "--env", "edgez"]
    args = ldm_main.get_args(argv)
    t0 = time.perf_counter()
    reset_launch_counts()
    run = ldm_main.train(args)
    torch.cuda.synchronize()
    counts = dict(LAUNCH_COUNTS)
    seconds = time.perf_counter() - t0
    model, steps, val_calls = run.state.module, run.state.step, run.val_calls
    layers = model.encoder.num_layers
    want = dict(packed_attention_backward=layers * steps,
                packed_attention=2 * layers * steps + layers * val_calls)
    others = {k: v for k, v in counts.items() if k not in want and v}
    if not model.encoder.remat or steps < 2 or val_calls < 1 or others or any(
            counts[k] != v for k, v in want.items()):
        raise AssertionError(f"train: {steps} steps, {val_calls} validation calls, remat "
                             f"{model.encoder.remat}; launches {counts}, expected {want}")
    with open(run.metrics_path) as f:
        records = [json.loads(line) for line in f]
    losses = [r["loss"] for r in records if "loss" in r]
    vals = {k: v for r in records for k, v in r.items() if k.startswith("Val-")}
    epochs = [r for r in records if "epoch_seconds" in r]
    finite = all(torch.isfinite(p).all().item() for p in model.parameters())
    if (not losses or not np.isfinite(losses + list(vals.values())).all() or len(vals) != 3
            or not finite):
        raise AssertionError(f"train: losses {losses}, validation {vals}, finite parameters "
                             f"{finite}")
    # the first epoch holds the warm-up (cuDNN, cuBLAS, the allocator)
    steady = epochs[1:]
    ms_per_step = 1e3 * sum(r["epoch_seconds"] for r in steady) / sum(
        r["epoch_steps"] for r in steady)
    log(f"train: ldm_main {' '.join(TRAIN_ARGS)}: {steps} steps of B=128 S=600 W=768 in "
        f"{seconds:.2f} s (whole run, VAE packs and data included); epoch seconds "
        + ", ".join(f"{r['epoch_seconds']:.3f}" for r in epochs)
        + f"; {ms_per_step:.1f} ms per step after the first epoch; K5 launches "
        f"{counts['packed_attention_backward']} = {layers} x {steps} steps, K1 launches "
        f"{counts['packed_attention']} = 2 x {layers} x {steps} + {layers} x "
        f"{val_calls} validation calls; losses " + ", ".join(f"{x:.4f}" for x in losses)
        + f"; validation {vals}")

    # the written pack, strictly reloaded, gives the trained module's forward
    pack = os.path.join(args.save_dir, f"epoch_{TRAIN_EPOCHS}.npz")
    fresh = load_params(pack, build_denoiser("edgez")).to("cuda").eval()
    gen = torch.Generator(device="cuda").manual_seed(1)
    streams = [torch.randn((2, 600, d), generator=gen, device="cuda")
               for d in model.stream_dims.values()]
    mask = torch.zeros((2, 600), dtype=torch.bool, device="cuda")
    mask[1, 300:] = True
    t = torch.tensor([5, 600], device="cuda")
    model.eval()
    with torch.no_grad():
        reload_diff = (fresh(streams, t, mask) - model(streams, t, mask)).abs().max().item()
    if reload_diff != 0.0:
        raise AssertionError(f"train: the reloaded pack's forward differs by {reload_diff:.3e}")
    del fresh, run, model
    torch.cuda.empty_cache()

    # one f32 step through the kernels against the same step through plain
    # attention: the same parameters, batch, draws and dropout seeds
    ds = make_dataset(GRAD_BATCH, seed=5)
    raw = assemble_edgez_batched(ds, list(range(GRAD_BATCH)), max_face=30, max_edge=20)
    keys = ldm_main.BATCH_KEYS["edgez"]
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in zip(keys, raw)}
    encode = {o: make_encoder_fn(ldm_main.load_vae(o, os.path.join(PACKS, f), "cuda"))
              for o, f in (("surface", "surf_vae.npz"), ("edge", "edge_vae.npz"))}
    tables = make_ddpm_tables()
    grads = {}
    for impl in ("kernel", "plain"):
        net = build_denoiser("edgez", attn_impl=impl)
        net = seed_weights(net, torch.Generator().manual_seed(2)).to("cuda")
        step = ldm_train.make_edgez_step(net, tables, encode["surface"], encode["edge"])
        capture = GradCapture(net)
        reset_launch_counts()
        metrics = step(TrainState(net, capture), batch, torch.Generator().manual_seed(3))
        torch.cuda.synchronize()
        grads[impl] = (capture.grads, float(metrics["loss"]), dict(LAUNCH_COUNTS))
        del net, step, capture
    (gk, loss_k, ck), (gp, loss_p, cp) = grads["kernel"], grads["plain"]
    if set(gk) != set(gp):
        raise AssertionError(f"train: gradients of {sorted(set(gk) ^ set(gp))} on one side only")
    norm = lambda ts: torch.sqrt(sum((t.double() ** 2).sum() for t in ts)).item()  # noqa: E731
    rel = norm(gk[n] - g for n, g in gp.items()) / norm(gp.values())
    worst, worst_name = max((norm([gk[n] - g]) / max(norm([g]), 1e-30), n)
                            for n, g in gp.items())
    if (not rel <= GRAD_REL or ck["packed_attention_backward"] != 12
            or cp["packed_attention_backward"] or abs(loss_k - loss_p) > 1e-4):
        raise AssertionError(f"train: f32 kernel step against plain: global relative gradient "
                             f"difference {rel:.3e} (bar {GRAD_REL:g}), worst tensor "
                             f"{worst_name} {worst:.3e}, losses {loss_k} / {loss_p}, launches "
                             f"{ck} / {cp}")
    log(f"train: reloaded pack's forward equals the trained module's (max abs diff "
        f"{reload_diff:g}); f32 step at B={GRAD_BATCH} S=600 through K1/K5 against plain "
        f"attention: loss {loss_k:.6f} / {loss_p:.6f}, global relative gradient difference "
        f"{rel:.3e} (bar {GRAD_REL:g}); largest relative difference of one tensor "
        f"{worst:.3e} ({worst_name})")
    return dict(path="train (ldm_main edgez, production width, bf16, B=128, S=600)",
                launches=counts["packed_attention_backward"], k1_launches=counts["packed_attention"],
                steps=steps, val_calls=val_calls, seconds=seconds, ms_per_step=ms_per_step, losses=losses, validation=vals,
                reload_max_abs_diff=reload_diff, f32_grad_rel=rel, f32_grad_worst=worst)


def chamfer_bound(S, R, P, n):
    """2 directions x S*R*n^2 distances x 8 FLOP (3 sub, 3 mul, 2 add) in
    f32 against each cloud read once and the matrix written once."""
    flops = 2.0 * S * R * n * n * 8
    nbytes = (S + R) * P * 3 * 4 + S * R * 4
    t_ops, t_bytes = flops / PEAK_FLOPS["float32"] * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def cdist_yardstick(torch, x, y, refs=64):
    """Several PyTorch calls for the same matrix: torch.cdist on blocks of
    one sample against ``refs`` references, squared, then amin and mean in
    both directions. A yardstick only; the port never calls it."""
    out = torch.empty((x.shape[0], y.shape[0]), device=x.device)
    for i in range(x.shape[0]):
        for j in range(0, y.shape[0], refs):
            yj = y[j:j + refs]
            d2 = torch.cdist(x[i].expand(len(yj), -1, -1), yj) ** 2
            out[i, j:j + refs] = d2.amin(2).mean(1) + d2.amin(1).mean(1)
    return out


def phase_chamfer(torch, gen):
    from brepgen_tpu_torch.kernels.chamfer import chamfer_matrix, chamfer_matrix_reference

    shapes = []
    for S, R, P, n in CHAMFER_SHAPES:
        x = torch.randn((S, P, 3), generator=gen, device="cuda")
        y = torch.randn((R, P, 3), generator=gen, device="cuda")
        x[:, n:] = 1e3  # padding past n_pts: the kernel must not read it
        got = chamfer_matrix(x, y, n_pts=n)
        want = chamfer_matrix_reference(x, y, n)
        diff = (got - want).abs()
        err = diff.max().item()
        over = (diff - (CHAMFER_REL * want.abs() + CHAMFER_ABS)).max().item()
        tol = f"|err| <= {CHAMFER_REL:g}*|plain| + {CHAMFER_ABS:g}"
        if over > 0 or not torch.isfinite(got).all():
            raise AssertionError(f"chamfer S={S} R={R} P={P} n={n}: max_abs_err {err:.3e} "
                                 f"({over:.3e} over the bound); tolerance {tol}")
        row = dict(S=S, R=R, P=P, n_pts=n, max_abs_err=err,
                   mean_value=want.mean().item())
        row["bound_ms"], row["bound_by"] = chamfer_bound(S, R, P, n)
        if len(shapes) == 0:
            row["ms"] = time_ms(torch, lambda: chamfer_matrix(x, y, n_pts=n), 5)
            row["plain_ms"] = time_ms(torch, lambda: chamfer_matrix_reference(x, y, n), 1)
            row["yardstick_ms"] = time_ms(torch, lambda: cdist_yardstick(torch, x, y), 1)
            times = (f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, cdist "
                     f"yardstick (several calls) {row['yardstick_ms']:.4f} ms, bound "
                     f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
        else:
            times = f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})"
        shapes.append(row)
        log(f"kernel chamfer S={S} R={R} P={P} n_pts={n}: max_abs_err {err:.3e} (mean "
            f"value {row['mean_value']:.4f}); tolerance {tol}; {times}")
        del x, y, got, want, diff
    S, R, P = CHAMFER_PROTOCOL
    x = torch.randn((S, P, 3), generator=gen, device="cuda")
    y = torch.randn((R, P, 3), generator=gen, device="cuda")
    row = dict(S=S, R=R, P=P, n_pts=P, ms=time_ms(torch, lambda: chamfer_matrix(x, y), 1))
    row["bound_ms"], row["bound_by"] = chamfer_bound(S, R, P, P)
    if not torch.isfinite(chamfer_matrix(x, y)).all():
        raise AssertionError("chamfer at one protocol repeat: non-finite values")
    shapes.append(row)
    log(f"kernel chamfer at one eval protocol repeat S={S} R={R} P={P}: kernel "
        f"{row['ms']:.2f} ms, bound {row['bound_ms']:.2f} ms ({row['bound_by']})")
    del x, y
    torch.cuda.empty_cache()
    return shapes


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


ATTENTION_KERNELS = ("packed_attention", "packed_flash_attention", "set_attention")


def drive(torch, np, label, cascade, expected_edge_calls, batches=1, save_folder=None,
          kernel="packed_attention"):
    """Run ``batches`` batches through the user's entry point, with host
    postprocess into ``save_folder`` when one is given; check the batches
    and the kernel counts (reset just before, read just after): ``kernel``
    once per layer of every edge-stage call, no other attention kernel."""
    from brepgen_tpu_torch.cli.sample_main import sample_loop
    from brepgen_tpu_torch.kernels import LAUNCH_COUNTS, reset_launch_counts

    cfg = cascade.cfg
    net = cascade.nets["edgez"]
    layers = net.encoder.num_layers
    events = []
    stage_times = {}
    calls0 = sum(cascade.model_calls[s] for s in ("edgepos", "edgez"))
    with tempfile.TemporaryDirectory() as tmp:
        folder = save_folder or tmp
        reset_launch_counts()
        run = sample_loop(cascade, max_batches=batches, seed=0, save_folder=folder,
                          stage_times=stage_times, postprocess=save_folder is not None,
                          recovery=True, workers=4,
                          after_stage=lambda s: events.append((s, LAUNCH_COUNTS[kernel])))
        counts = dict(LAUNCH_COUNTS)
        with np.load(os.path.join(folder, "batches.npz")) as saved:
            want = sorted(f"{k}__{b}" for b in range(batches) for k in run.batches[0])
            if sorted(saved.files) != want:
                raise AssertionError(f"batches.npz keys {saved.files}")
    launches = counts[kernel]
    others = {k: counts[k] for k in ATTENTION_KERNELS if k != kernel and counts[k]}
    kept = [check_batch(np, b, cfg.batch_size, cfg.faces, cfg.num_edges) for b in run.batches]
    edge_calls = sum(cascade.model_calls[s] for s in ("edgepos", "edgez")) - calls0
    if edge_calls != batches * expected_edge_calls:
        raise AssertionError(f"{label}: {edge_calls} edge-stage calls, expected "
                             f"{batches} x {expected_edge_calls}")
    per_stage, prev = {}, 0
    for stage, count in events:
        per_stage[stage] = per_stage.get(stage, 0) + count - prev
        prev = count
    off_edge = {k: v for k, v in per_stage.items() if not k.startswith("edge") and v}
    if off_edge or others or launches != layers * edge_calls or prev != launches:
        raise AssertionError(f"{label}: {launches} {kernel} launches (by stage {per_stage}), "
                             f"expected {layers} x {edge_calls} edge-stage calls, none elsewhere; "
                             f"other attention kernels {others}")
    if counts["chamfer"]:
        raise AssertionError(f"{label}: the sampling path launched the chamfer kernel")
    cascade_s = sum(stage_times.values())
    bucket = cascade.last_bucket
    log(f"{label}: {batches} batch(es) of B={cfg.batch_size} ns={cfg.faces} "
        f"ne={cfg.num_edges} S={cfg.faces * cfg.num_edges}; edge stages on {bucket} face slots "
        f"(S={bucket * cfg.num_edges}); edge-stage calls {edge_calls}; "
        f"{kernel} launches {launches} = {layers} layers x {edge_calls} (other stages and "
        f"attention kernels 0); kept (faces, edges) per batch {kept}; cascade stage seconds "
        + ", ".join(f"{k} {v:.2f}" for k, v in stage_times.items())
        + f"; total {run.seconds:.2f} s, {run.seconds / batches:.2f} s per batch")
    if save_folder is not None:
        log(f"{label}: postprocess overlapped with the cascade ({run.attempted} samples, 4 "
            f"threads): " + run.report().replace("\n", "; "))
        if run.attempted != batches * cfg.batch_size:
            raise AssertionError(f"{label}: {run.attempted} samples post-processed")
    return dict(path=label, kernel=kernel, B=cfg.batch_size, S=cfg.faces * cfg.num_edges,
                edge_faces=bucket, W=net.width, H=net.encoder.layer_0.attn.num_heads,
                dtype=str(net.dtype).split(".")[-1], batches=batches, launches=launches,
                edge_calls=edge_calls, seconds=run.seconds, cascade_seconds=cascade_s,
                stage_seconds=stage_times, produced=run.produced,
                attempted=run.attempted), run


def phase_solids(torch, np, cascade, batch, folder):
    """Batch 0 of the protocol run through ``process_one`` with recovery, one
    sample after another (no overlap): STEP + STL into ``folder``."""
    from brepgen_tpu_torch.cli.sample_main import SampleRun, host_decoders, process_one
    from brepgen_tpu_torch.kernels import LAUNCH_COUNTS, reset_launch_counts

    surf_decode, edge_decode = host_decoders(cascade)
    run = SampleRun(batches=[batch])
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    per_sample = []
    for b in range(cascade.cfg.batch_size):
        t = time.perf_counter()
        name, note = process_one(batch, b, surf_decode, edge_decode, cascade.cfg.z_threshold,
                                 folder, recovery=True, device=cascade.device)
        per_sample.append(time.perf_counter() - t)
        run.add(name, note)
        run.attempted += 1
        if name is not None:
            for suffix in (".step", ".stl"):
                path = os.path.join(folder, name + suffix)
                if not os.path.getsize(path):
                    raise AssertionError(f"solids: {path} is empty")
    torch.cuda.synchronize()
    run.seconds = time.perf_counter() - t0
    if any(LAUNCH_COUNTS.values()):
        raise AssertionError(f"solids: postprocess launched port kernels {LAUNCH_COUNTS}")
    if run.produced < 1:
        raise AssertionError(f"solids: no valid solid from the protocol batch; {run.report()}")
    log("solids (all160k protocol batch 0, process_one with recovery, serial): "
        + run.report().replace("\n", "; ")
        + "; seconds per sample " + ", ".join(f"{t:.2f}" for t in per_sample))
    return dict(attempted=run.attempted, produced=run.produced, strict=run.strict,
                solid=run.solid, failures=run.failures, rungs=run.rungs, seconds=run.seconds)


def reference_clouds(np, folder, seed, count=64, n=2000):
    """``count`` clouds of ``n`` points on the surfaces of random boxes
    (sides 0.2 to 1, area-weighted faces), written as PLY."""
    from brepgen_tpu_torch.geometry.ply import write_ply

    rng = np.random.default_rng(seed)
    os.makedirs(folder)
    for i in range(count):
        size = rng.uniform(0.2, 1.0, 3)
        areas = np.array([size[1] * size[2], size[0] * size[2], size[0] * size[1]] * 2)
        face = rng.choice(6, size=n, p=areas / areas.sum())
        pts = rng.uniform(0, 1, (n, 3)) * size
        axis = face % 3
        pts[np.arange(n), axis] = np.where(face < 3, 0.0, size[axis])
        write_ply(os.path.join(folder, f"box_{i:03d}.ply"), pts)


def phase_eval(torch, np, stl_root, work, seed, times=3):
    """STLs -> 2000-point clouds -> JSD / MMD-CD / COV-CD against box clouds,
    the Chamfer matrices through kernel K4 (one launch per repeat)."""
    from brepgen_tpu_torch.eval.pipeline import find_files, run_metrics, sample_points_dir
    from brepgen_tpu_torch.geometry.ply import read_ply
    from brepgen_tpu_torch.kernels import LAUNCH_COUNTS, reset_launch_counts

    fake, real = os.path.join(work, "fake_ply"), os.path.join(work, "real_ply")
    t0 = time.perf_counter()
    n_fake = sample_points_dir(stl_root, fake, seed=seed)
    for p in find_files(fake, ".ply"):
        pc = read_ply(p)
        if pc.shape != (2000, 3) or not np.isfinite(pc).all():
            raise AssertionError(f"eval: {p} holds {pc.shape} points")
    reference_clouds(np, real, seed)
    t1 = time.perf_counter()
    reset_launch_counts()
    avg = run_metrics(fake, real, n_test=64, multi=3, times=times, seed=seed, device="cuda")
    torch.cuda.synchronize()
    launches = dict(LAUNCH_COUNTS)
    t2 = time.perf_counter()
    if launches["chamfer"] != times or launches["packed_attention"]:
        raise AssertionError(f"eval: launches {launches}, expected {times} chamfer (one "
                             f"per repeat) and nothing else")
    ok = (np.isfinite(list(avg.values())).all() and avg["avg-MMD-CD"] > 0
          and 0 < avg["avg-COV-CD"] <= 1 and 0 <= avg["avg-JSD"] <= 1)
    if not ok:
        raise AssertionError(f"eval: metrics out of range {avg}")
    log(f"eval: {n_fake} STLs sampled to 2000-point clouds in {t1 - t0:.2f} s; "
        f"against 64 random-box clouds (seed {seed}), {times} repeats in {t2 - t1:.2f} s, "
        f"chamfer launches {launches['chamfer']} (one per repeat); SMOKE values, not a "
        f"quality number: " + ", ".join(f"{k} {v:.6f}" for k, v in avg.items()))
    return dict(clouds=n_fake, launches=launches["chamfer"], seconds=t2 - t1, metrics=avg)


def phase_abc_compact(torch, np):
    """Mode abc on the all160k packs, batch 4, DDIM, without and with
    face-token compaction: the same noise, so the kept faces' outputs agree."""
    from brepgen_tpu_torch.cli.sample_main import init_cascade

    runs = {}
    for compact in (False, True):
        cascade = init_cascade("abc", PACKS, batch_size=4, device="cuda",
                               step_overrides={"fast_steps": ABC_STEPS, "compact": compact})
        label = f"abc {'compact' if compact else 'full'} (all160k packs, DDIM {ABC_STEPS})"
        path, run = drive(torch, np, label, cascade, 2 * ABC_STEPS)
        runs[compact] = (path, run.batches[0])
        faces = cascade.cfg.faces
        del cascade
    (full_path, full), (comp_path, comp) = runs[False], runs[True]
    if not comp_path["edge_faces"] < faces:
        raise AssertionError(f"abc compact: bucket {comp_path['edge_faces']} of {faces} slots")
    if not np.array_equal(full["surf_mask"], comp["surf_mask"]):
        raise AssertionError("abc compact: the face masks differ")
    keep = ~full["surf_mask"]
    if not np.array_equal(full["edge_mask"][keep], comp["edge_mask"][keep]):
        raise AssertionError("abc compact: the edge masks of kept faces differ")
    errs = {k: float(np.abs(full[k][keep] - comp[k][keep]).max())
            for k in ("surf_pos", "surf_z", "edge_pos", "edge_z", "edge_v", "edge_ncs")}
    if max(errs.values()) > COMPACT_TOL:
        raise AssertionError(f"abc compact: kept-face outputs differ {errs} > {COMPACT_TOL:g}")
    edge_s = {c: p["stage_seconds"]["edgepos"] + p["stage_seconds"]["edgez"]
              for c, p in ((False, full_path), (True, comp_path))}
    log(f"abc compact: bucket {comp_path['edge_faces']} of {faces} face slots (kept faces per "
        f"sample {keep.sum(1).tolist()}); edge-stage seconds {edge_s[False]:.2f} full, "
        f"{edge_s[True]:.2f} compacted; kept-face max abs diff {max(errs.values()):.3e} "
        f"(tolerance {COMPACT_TOL:g}; by output {errs})")
    return [full_path, dict(comp_path, kept_face_max_abs_diff=errs)]


def phase_long_set(torch, np, work):
    """A config file of eval_config_tpu.yaml's form with 70 x 60 face and edge
    slots, through the sample CLI's --config: 140 x 60 = 8400 tokens."""
    from brepgen_tpu_torch.cli.sample_main import cascade_from_args, parse_args

    config = os.path.join(work, "long_set.yaml")
    keys = dict(batch_size=2, z_threshold=0.2, bbox_threshold=0.08, num_surfaces=70,
                num_edges=60, use_cf=False, class_label=[])
    with open(config, "w") as f:
        f.write("abc:\n" + "".join(f"  {k}: {v}\n" for k, v in keys.items()))
    args = parse_args(["--mode", "abc", "--config", config, "--fast_steps", str(LONG_STEPS),
                       "--max_batches", "1"])
    cascade = cascade_from_args(args)
    cfg = cascade.cfg
    if (cfg.batch_size, cfg.faces * cfg.num_edges) != (2, 8400):
        raise AssertionError(f"long set: --config gave {cfg}")
    path, _ = drive(torch, np, f"long set (--config 70 x 60, production width, seeded, DDIM "
                    f"{LONG_STEPS})", cascade, 2 * LONG_STEPS, kernel="packed_flash_attention")
    return path


def kernel_entry(name, source, replaces, launches, shapes, paths, **extra):
    """A line of the kernels JSON: the numbers of the first (main) shape."""
    main_shape = shapes[0]
    return dict(name=name, route="cuda", source=source, replaces=replaces, launches=launches,
                max_abs_err=max(r["max_abs_err"] for r in shapes if "max_abs_err" in r),
                ms=main_shape["ms"], plain_ms=main_shape["plain_ms"],
                bound_ms=main_shape["bound_ms"], bound_by=main_shape["bound_by"],
                library_ms=main_shape.get("library_ms"), **extra, shapes=shapes, paths=paths)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the reference clouds of the eval phase and its cloud draws")
    args = p.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    # full f32 in matrix products and convolutions, as the CPU reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from concurrent.futures import ThreadPoolExecutor

    from brepgen_tpu_torch.cli.sample_main import init_cascade
    from brepgen_tpu_torch.diffusion import make_pndm_plan
    from brepgen_tpu_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t = time.perf_counter()
    kernels = ("packed_attention", "set_attention", "chamfer", "packed_attention_bwd")
    with ThreadPoolExecutor(len(kernels)) as pool:  # one nvcc per source, together
        list(pool.map(_build.load, kernels))
    build_s = time.perf_counter() - t
    log(f"env: python {sys.version.split()[0]}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, card {torch.cuda.get_device_name(0)} ({smi}), "
        f"{torch.cuda.device_count()} visible; {', '.join(kernels)} built in {build_s:.2f} s")
    for name in kernels:
        secs, report = _build.BUILD_LOG.get(name, (0.0, ""))
        log(f"  nvcc {name}: {secs:.2f} s")
        for ln in report.splitlines():
            if "registers" in ln or "spill" in ln or "entry function" in ln:
                log(f"  ptxas: {ln.strip()}")

    shapes = {k: [] for k in ATTENTION_KERNELS}
    for kernel, kernel_shapes in (("packed_attention", KERNEL_SHAPES),
                                  ("set_attention", K3_SHAPES),
                                  ("packed_flash_attention", K2_SHAPES)):
        t = time.perf_counter()
        phase_attention(torch, kernel, kernel_shapes, shapes[kernel])
        log(f"phase kernel {kernel} done in {time.perf_counter() - t:.2f} s")

    t = time.perf_counter()
    backward_shapes = []
    phase_backward(torch, backward_shapes)
    log(f"phase kernel packed_attention_backward done in {time.perf_counter() - t:.2f} s")

    t = time.perf_counter()
    chamfer_shapes = phase_chamfer(torch, torch.Generator(device="cuda").manual_seed(args.seed))
    log(f"phase kernel chamfer done in {time.perf_counter() - t:.2f} s")

    t = time.perf_counter()
    phase_small(torch)
    log(f"phase small done in {time.perf_counter() - t:.2f} s")

    paths = {k: [] for k in ATTENTION_KERNELS}
    t = time.perf_counter()
    cascade = init_cascade("deepcad", seed=0, batch_size=16, device="cuda",
                           step_overrides={"fast_steps": DEEPCAD_STEPS})
    log(f"cascade: production weights seeded in {time.perf_counter() - t:.2f} s")
    path, _ = drive(torch, np, f"cascade (production width, seeded, DDIM {DEEPCAD_STEPS})",
                    cascade, 2 * DEEPCAD_STEPS)
    paths["packed_attention"].append(path)
    del cascade
    torch.cuda.empty_cache()
    log(f"phase cascade done in {time.perf_counter() - t:.2f} s")

    t = time.perf_counter()
    cascade = init_cascade("abc", seed=0, batch_size=16, device="cuda",
                           step_overrides={"fast_steps": ABC_STEPS})
    log(f"abc: production weights seeded in {time.perf_counter() - t:.2f} s")
    path, _ = drive(torch, np, f"abc (production width, seeded, f32, DDIM {ABC_STEPS})",
                    cascade, 2 * ABC_STEPS, kernel="set_attention")
    paths["set_attention"].append(path)
    del cascade
    torch.cuda.empty_cache()
    log(f"phase abc done in {time.perf_counter() - t:.2f} s")

    t = time.perf_counter()
    paths["packed_attention"] += phase_abc_compact(torch, np)
    torch.cuda.empty_cache()
    log(f"phase abc compact done in {time.perf_counter() - t:.2f} s")

    with tempfile.TemporaryDirectory() as work:
        t = time.perf_counter()
        paths["packed_flash_attention"].append(phase_long_set(torch, np, work))
        torch.cuda.empty_cache()
        log(f"phase long set done in {time.perf_counter() - t:.2f} s")

        t = time.perf_counter()
        cascade = init_cascade("deepcad", PACKS, batch_size=4, device="cuda")
        log(f"protocol: all160k packs loaded in {time.perf_counter() - t:.2f} s")
        cfg = cascade.cfg
        expected = (cfg.pos_pndm_calls + cfg.ddpm_tail
                    + len(make_pndm_plan(cfg.pndm_steps).t_model))
        path, run = drive(torch, np, "protocol (all160k packs, PNDM + DDPM)", cascade, expected)
        paths["packed_attention"].append(path)
        log(f"phase protocol done in {time.perf_counter() - t:.2f} s")

        t = time.perf_counter()
        serial_dir = os.path.join(work, "solids", "serial")
        os.makedirs(serial_dir)
        solids = phase_solids(torch, np, cascade, run.batches[0], serial_dir)
        log(f"phase solids done in {time.perf_counter() - t:.2f} s")

        # the user's path: host postprocess of batch k overlaps the cascade of
        # batch k + 1, against the same work one after the other
        t = time.perf_counter()
        serial = path["seconds"] + solids["seconds"]
        path, _ = drive(torch, np, "protocol with postprocess (all160k packs, 4 threads)",
                        cascade, expected, batches=2,
                        save_folder=os.path.join(work, "solids", "overlapped"))
        paths["packed_attention"].append(path)
        overlapped = path["seconds"] / path["batches"]
        solids.update(seconds_per_batch_overlapped=overlapped, seconds_per_batch_serial=serial)
        log(f"phase overlap done in {time.perf_counter() - t:.2f} s; seconds per batch: "
            f"{overlapped:.2f} with postprocess overlapping the next cascade (cascade stages "
            f"{path['cascade_seconds'] / path['batches']:.2f} of it), {serial:.2f} one after "
            f"the other (cascade {serial - solids['seconds']:.2f} + postprocess "
            f"{solids['seconds']:.2f})")

        t = time.perf_counter()
        evaluation = phase_eval(torch, np, os.path.join(work, "solids"), work, args.seed)
        log(f"phase eval done in {time.perf_counter() - t:.2f} s")
        del cascade
        torch.cuda.empty_cache()

        t = time.perf_counter()
        training = phase_train(torch, np, os.path.join(work, "train"))
        log(f"phase train done in {time.perf_counter() - t:.2f} s")

    # the top-level numbers are those of the main shape (the first of each
    # kernel's shapes: production width in f32; chamfer: the n=256 eval
    # protocol) and launches those of the kernel's first driven path; "shapes"
    # has every measured shape, "paths" every run
    csrc = "brepgen_tpu_torch/kernels/csrc/"
    print(json.dumps({"kernels": [
        kernel_entry("packed_attention", csrc + "packed_attention.cu",
                     "brepgen_tpu/kernels/attention.py:150",
                     paths["packed_attention"][0]["launches"], shapes["packed_attention"],
                     paths["packed_attention"]),
        kernel_entry("packed_flash_attention", csrc + "packed_attention.cu",
                     "brepgen_tpu/kernels/attention.py:261",
                     paths["packed_flash_attention"][0]["launches"],
                     shapes["packed_flash_attention"], paths["packed_flash_attention"]),
        kernel_entry("set_attention", csrc + "set_attention.cu",
                     "brepgen_tpu/kernels/attention.py:47",
                     paths["set_attention"][0]["launches"], shapes["set_attention"],
                     paths["set_attention"]),
        kernel_entry("chamfer", csrc + "chamfer.cu", "brepgen_tpu/kernels/chamfer.py:47",
                     evaluation["launches"], chamfer_shapes,
                     [dict(path="eval (STL -> clouds -> JSD/MMD/COV)", **evaluation),
                      dict(path="solids (protocol batch 0, serial)", **solids)],
                     yardstick_ms=chamfer_shapes[0]["yardstick_ms"]),
        kernel_entry("packed_attention_backward", csrc + "packed_attention_bwd.cu",
                     "brepgen_tpu/kernels/attention.py:377", training["launches"],
                     backward_shapes, [training],
                     packed_attention_ms=backward_shapes[0]["packed_attention_ms"]),
    ]}), flush=True)
    log(f"all phases passed in {time.perf_counter() - T0:.2f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
