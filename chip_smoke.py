#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on the card.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py [--seed N]

It builds the port's CUDA kernels from ``brepgen_tpu_torch/kernels/csrc`` with
nvcc (one nvcc per source, started together) and holds each attention entry
(K1 packed, K3 per-head, K2 long-set), the Chamfer kernel and the packed
attention's backward (K5) against its plain PyTorch version on the card, the
attention kernels at head widths 64, 32 and 16. After small cascades on the
card against the same ones on the CPU (the sample CLI's ``--small``
architecture, head width 16, and width 64 with 2 heads) it drives the
port's own entry points: the deepcad and abc cascades at the production width (seeded weights, DDIM fast mode;
abc in f32 takes the per-head kernel), abc on the committed all160k packs
without and with face-token compaction, a long set of 8400 tokens through
the sample CLI's ``--config`` (the long-set kernel), the default PNDM + DDPM
protocol on the all160k packs with host postprocess overlapping the cascade
(STEP + STL), one batch post-processed serially, and point clouds from the
solids scored against reference clouds drawn from ``--seed`` through the
Chamfer kernel (K4, also held to its plain version on the real clouds of
phases eval and rescore). On the card every cascade replays each stage's
denoiser call from a CUDA graph, as the entry points do; after each of the
deepcad, abc, all160k abc (full and compacted) and long-set runs its graphs
leg runs the same cascade eagerly on the same noise and holds the captured
run to it (outputs of every batch, kernel launches per batch, seconds per
stage at each batch index). Phase rescore samples the all160k packs at their
training size (10 x 8, B=16, bf16, captured) through ``resample_main
--recover --dump``, replays the dump strictly, holds the captured batch 0 to
the same batch eagerly, and scores both sets through ``metrics_main``
against 64 held-out clouds (K4); it fails below 90% recovered or 50% strict
validity. Then the training CLI trains the edgez denoiser at the
production width in bf16 (K1 forward and K5 backward in every layer of every
step), its pack is reloaded, and one f32 step through the kernels is held
against the same step through plain attention. Phase pipeline then runs the
user's workflow from solids, in a temporary directory under ``build/``:
``process_main --synthetic``, ``eval_main dedup`` for surfaces and edges,
``vae_main`` for both VAEs at production width in bf16 (the packs reload
with a bit-equal decode; a B=512 edge step timed), ``ldm_main`` on edgez
with ``--cache_latents`` and ``--profile`` on those solids and packs (K1 and
K5 launch counts, the cache's hits and misses, the trace's device idle
share), the same run encoding in the step, the cache's latents from a
producer thread against the step's encode, and one f32 step with ``--remat
dots`` against ``--remat on`` (gradients, K1 launches, peak memory). Phase
step ingests STEP files on the host: every STEP file of phases solids and
overlap passes the port's conformance validator (and ``validate_solid``
where it holds a solid), 240 of the pipeline's solids are written as STEP,
extracted back by ``shard_driver`` in four ``process_main`` subprocesses
(one pkl each, within 5e-2 of the source grids, no failed shard), split,
deduplicated and trained on by ``ldm_main`` edgez in bf16 with the
pipeline's VAE packs (K1 and K5 launch counts). Phase dp is multi-GPU on
the one card: ``ldm_main --dp`` under ``torchrun --nproc_per_node 1``
(NCCL) against the same command without ``--dp`` (equal per-step losses,
K1/K5 launch counts, a pack without DDP's prefix), then two ranks of this
script (``--dp_worker``) sharing the card over gloo: one split edgez step
against one process, split sampling (deepcad; abc compacted on one bucket)
and the tensor-parallel edgez forward (6 heads a rank through K1) against
the replicated one, while a reference-layout checkpoint goes through
``tools/convert_torch.py`` into a pack whose forward equals its source.
Phase graft_entry runs ``brepgen_tpu_torch/graft_entry.py``: ``entry()`` (the
flagship edgez denoiser, head width 16, through K1) against the CPU, then
``dryrun_multichip(4)``: four gloo ranks sharing the card take the edgez
step on a 2 x 2 data x model mesh (tensor-parallel training through K1/K5
at head width 16), held to the same step in one process, and split the
tiny cascade 4 ways against the unsharded one. Phase bench runs the
measuring entry points at production size: ``brepgen_tpu_torch/bench.py``
(captured steps and a measured deepcad batch), ``tools/bench_cascade.py``'s
``time:edgez@24``, the train-step bench's plain and kernel legs, the Chamfer
protocol bench and ``io_bench cached_only``, each with its K1, K4 and K5
launches asserted.
The native host library (trimming) is built with g++ beside the kernels. It checks shapes,
finiteness, masks, solids, agreement of the compacted and full runs, the
gradients, and kernel launch counts. Each phase prints one line with its
seconds. The last lines are one JSON object of kernel measurements and the
result line. Any failure raises and exits non-zero; without a CUDA card it exits 1 and prints no result. It imports
torch, numpy and ``brepgen_tpu_torch`` only.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import re
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
# f32 attention (K1, K2, K3, K5 alike) is bounded at the tensor cores' rate
# through 3xTF32, three TF32 products for one f32 product; the bound at the
# f32 rate outside the tensor cores is kept beside it as bound_ms_f32_simt.
# K4 stays at the f32 rate.
PEAK_FLOPS_ATTENTION = {"float32": 495e12 / 3, "bfloat16": 989e12}
# Sources whose kernels run on the tensor cores: each kernel function in
# their cubins must hold HMMA or HGMMA instructions, and each bf16 one
# HGMMA (wgmma) and UTMALDG (TMA) ones
TENSOR_CORE_SOURCES = ("set_attention", "packed_attention_bwd", "packed_attention")
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
# and head width 16 at width 32 with 2 heads (the CLIs' --small)
KERNEL_SHAPES = ((16, 1800, 768, 12), (4, 1800, 256, 8), (16, 1800, 32, 2))
K3_SHAPES = ((16, 4000, 768, 12), (4, 4000, 256, 8), (16, 4000, 32, 2))
K2_SHAPES = ((2, 8400, 768, 12), (4, 8400, 256, 8), (2, 8400, 32, 2))
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
# width; held per element to its plain version in f32 and to the same
# function with its sums in f64, with the forward's REL/ABS bars. Not to
# MAX_ABS: a gradient sums over S rows (dV of the one key of a one-key
# sample is the sum of 600 rows of dO, about 60), so its bf16 rounding alone
# exceeds 2e-2. K5_LONG is the card test's longest set: dV of its one-key
# sample sums 1500 rows, where the plain version's own f32 sums leave the bar
# of the f64 sums (1.6e-4 on an H100); where they do, the drift is logged and
# K5 is held to the f64 sums alone, with the same bar. K1's output at these
# shapes, K5's input, is held to K1's plain version with all the forward's
# bars (MAX_ABS included): the first is the training step's K1.
K5_LONG = (4, 1500, 768, 12)
# the last at head width 16: the entry check's flagship (width 64, 4 heads)
K5_SHAPES = ((128, 600, 768, 12), (64, 160, 256, 8), K5_LONG, (128, 600, 64, 4))
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
# Captured stages against eager on the same noise: the same kernels in the
# same order, so bit-equal is expected; the bar is this share of each
# output's largest magnitude
GRAPH_REL = 1e-6
# Phase rescore: 4 batches of 16 (n=64), failing only below these validities,
# about 3 sigma under BASELINE.md's 70.3% strict at n=64
RESCORE_BATCHES = 4
RESCORE_MIN = {"recovered": 0.90, "strict": 0.50}


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


def roofline(flops, nbytes, dtype_name):
    """bound_ms, bound_by and, in f32, bound_ms_f32_simt of an attention
    kernel: the larger of its operations over the peak and its bytes over
    the memory rate."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS_ATTENTION[dtype_name] * 1e3
    row = dict(bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes")
    if dtype_name == "float32":
        row["bound_ms_f32_simt"] = max(flops / PEAK_FLOPS["float32"] * 1e3, t_bytes)
    return row


def attention_bound(B, S, W, dtype_name, itemsize):
    flops = 4.0 * B * S * S * W
    nbytes = B * S * 3 * W * itemsize + B * S + B * S * W * itemsize
    return roofline(flops, nbytes, dtype_name)


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
            row.update(attention_bound(B, S, W, name, qkv.element_size()))
            results.append(row)
            k1 = (f", K1 {row['packed_attention_ms']:.4f} ms" if "packed_attention_ms" in row
                  else "")
            func = {"set_attention": "set_attention"}.get(kernel, "packed_attention")
            func += "_wgmma_kernel" if name == "bfloat16" else "_kernel"
            tag = "bf16" if name == "bfloat16" else "f32"
            log(f"{label} {name}: {text}; kernel {row['ms']:.4f} ms, plain "
                f"{row['plain_ms']:.4f} ms, sdpa {row['library_ms']:.4f} ms{k1}, bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']}){simt_text(row)}; "
                + registers_text(kernel if kernel == "set_attention" else "packed_attention",
                                 f"{func}<{tag}, D={W // H}>"))
            del qkv, mask
            torch.cuda.empty_cache()


def simt_text(row):
    if "bound_ms_f32_simt" not in row:
        return ""
    return f", {row['bound_ms_f32_simt']:.4f} ms at the f32 rate outside the tensor cores"


def backward_bound(B, S, W, dtype_name, itemsize):
    """The five products of the backward (dV, dP, dQ, dK and the logits
    recomputed), 10*B*S^2*W operations, against qkv and dO read once and
    dqkv written once."""
    flops = 10.0 * B * S * S * W
    nbytes = B * S * 7 * W * itemsize + B * S
    return roofline(flops, nbytes, dtype_name)


def phase_backward(torch, results):
    """K5 at ``K5_SHAPES`` in f32 and bf16, given the forward's residuals
    (K1's training launch, made outside the timed region, as training hands
    them over: its output, itself held to K1's plain version with K1's
    bars, the training step's K1 at the first shape; its output in f32 and
    its rows' max and 1/sum, held to the plain version's): held per
    element to its plain version in f32 and to the same function with its
    sums in f64, the plain version's own drift from that logged beside (at
    ``K5_LONG``, where that drift leaves the bar, to the f64 sums alone);
    two launches bit-equal; timed beside the plain version, the SDPA
    backward (torch.autograd.grad through scaled_dot_product_attention with
    the -1e9 float mask; its forward runs outside the timed region) and K1's
    forward on the same inputs, without and with the residuals."""
    import torch.nn.functional as F

    from brepgen_tpu_torch.kernels.attention import (
        packed_attention,
        packed_attention_backward,
        packed_attention_backward_reference,
        packed_attention_reference,
        packed_attention_with_stats,
    )

    gen = torch.Generator(device="cuda").manual_seed(5)
    for B, S, W, H in K5_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            qkv = torch.randn((B, S, 3 * W), generator=gen, device="cuda").to(dtype)
            dout = torch.randn((B, S, W), generator=gen, device="cuda").to(dtype)
            mask = make_masks(torch, B, S, gen)
            label = f"kernel packed_attention_backward B={B} S={S} W={W} H={H}"
            fwd, o32, stats = packed_attention_with_stats(qkv, H, mask)
            want, m, inv_l = packed_attention_reference(qkv.float(), H, mask, with_stats=True)
            fwd_err, _, fwd_text = hold_to_plain(
                torch, label.replace("_backward", "") + " (K5's input)", fwd.float(), want, qkv,
                mask, W, name)
            # the residuals: the f32 output within the forward's bar, m a max
            # of the same f32 logits, 1/l an online sum in another order
            stat_err = dict(o32=(o32 - want).abs().max().item(),
                            m=(stats[..., 0] - m).abs().max().item(),
                            inv_l_rel=((stats[..., 1] - inv_l).abs() / inv_l).max().item())
            if (((o32 - want).abs() > REL[name] * want.abs() + ABS).any()
                    or ((stats[..., 0] - m).abs() > 1e-6 * m.abs() + ABS).any()
                    or stat_err["inv_l_rel"] > 1e-5 or not torch.equal(fwd, o32.to(dtype))):
                raise AssertionError(f"{label} {name}: K1's residuals off the plain ones: "
                                     f"{stat_err}")
            del want, m, inv_l
            torch.cuda.empty_cache()
            got = packed_attention_backward(qkv, dout, H, mask, out=o32, stats=stats).double()
            if not torch.isfinite(got).all():
                raise AssertionError(f"{label} {name}: non-finite gradient")
            wants = dict(plain=packed_attention_backward_reference(
                qkv.float(), dout.float(), H, mask).double(),
                f64=packed_attention_backward_reference(qkv, dout, H, mask, sums_in_f64=True))
            diff = (wants["plain"] - wants["f64"]).abs()
            drift = diff.max().item()
            plain_off = (diff - (REL[name] * wants["f64"].abs() + ABS)).max().item() > 0
            held = ("f64",) if plain_off and (B, S, W, H) == K5_LONG else ("plain", "f64")
            mag = wants["plain"].abs().mean().item()
            keys = (~mask).sum(1)
            tol = f"|err| <= {REL[name]:g}*|plain| + {ABS:g}"
            err, errs = {}, {}
            for ref, want in wants.items():
                diff = (got - want).abs()
                over = (diff - (REL[name] * want.abs() + ABS)).max().item()
                row_err = diff.amax(dim=(1, 2))
                err[ref] = diff.max().item()
                errs[ref] = {k: row_err[sel].max().item() for k, sel in
                             (("dense", keys > 1), ("one-key", keys == 1),
                              ("all-masked", keys == 0)) if sel.any()}
                if ref in held and over > 0:
                    raise AssertionError(f"{label} {name}: against the {ref} version "
                                         f"max_abs_err {err[ref]:.3e} (rows {errs[ref]}), "
                                         f"{over:.3e} over the bound; tolerance {tol}")
            del wants, want, diff
            again = packed_attention_backward(qkv, dout, H, mask, out=o32, stats=stats)
            if not torch.equal(again, packed_attention_backward(qkv, dout, H, mask, out=o32,
                                                                stats=stats)):
                raise AssertionError(f"{label} {name}: two launches differ")
            del again
            del got
            torch.cuda.empty_cache()
            row = dict(B=B, S=S, W=W, H=H, dtype=name, max_abs_err=err["plain"],
                       row_max_abs_err=errs["plain"], max_abs_err_f64=err["f64"],
                       plain_drift_f64=drift, held_to=list(held),
                       packed_attention_max_abs_err=fwd_err, residual_err=stat_err)
            row["ms"] = time_ms(torch, lambda: packed_attention_backward(
                qkv, dout, H, mask, out=o32, stats=stats), 10)
            row["plain_ms"] = time_ms(torch, lambda: packed_attention_backward_reference(
                qkv, dout, H, mask), 2)
            q, k, v = (a.detach().requires_grad_() for a in split_heads(qkv, H))
            g = dout.reshape(B, S, H, W // H).transpose(1, 2)
            bias = torch.where(mask[:, None, None, :], -1e9, 0.0).to(dtype)
            out = F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
            row["library_ms"] = time_ms(torch, lambda: torch.autograd.grad(
                out, (q, k, v), g, retain_graph=True), 3)
            del q, k, v, g, bias, out, fwd, o32, stats
            with torch.no_grad():
                row["packed_attention_ms"] = time_ms(
                    torch, lambda: packed_attention(qkv, H, mask), 10)
                row["packed_attention_train_ms"] = time_ms(
                    torch, lambda: packed_attention_with_stats(qkv, H, mask), 10)
            row.update(backward_bound(B, S, W, name, qkv.element_size()))
            results.append(row)
            fn = "_wgmma_kernel" if name == "bfloat16" else "_kernel"
            tag = f"<{'bf16' if name == 'bfloat16' else 'f32'}, D={W // H}>"
            log(f"{label} {name}: max_abs_err {err['plain']:.3e} (mean |plain| {mag:.3e}); by "
                "rows: " + ", ".join(f"{k} {v:.3e}" for k, v in errs["plain"].items())
                + f"; against the sums in f64 {err['f64']:.3e} ("
                + ", ".join(f"{k} {v:.3e}" for k, v in errs["f64"].items())
                + f"), the plain version's own drift from them {drift:.3e}"
                + ("" if "plain" in held else " (past the bar: held to the f64 sums alone)")
                + f"; tolerance {tol}; "
                f"two launches bit-equal; K1's residuals against the plain ones {stat_err}; "
                f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, sdpa backward "
                f"{row['library_ms']:.4f} ms, K1 forward {row['packed_attention_ms']:.4f} ms, "
                f"with its residuals {row['packed_attention_train_ms']:.4f} ms "
                f"({fwd_text}), bound {row['bound_ms']:.4f} ms ({row['bound_by']}){simt_text(row)}; "
                + registers_text("packed_attention_bwd", "dq" + fn + tag, "dkv" + fn + tag))
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


# Phase pipeline: the user's workflow from solids to a cached LDM run, at
# production width, in a temporary directory under build/. 2300 synthetic
# solids deduplicate to 1498 (1200 in the train split, 9 steps of B=128 an
# epoch), so epoch 2 holds steps 9-17 and the --profile window (step 10 to
# the end of its epoch, as the JAX CLI closes it) traces steps 10-17.
PIPELINE_SOLIDS = 2300
VAE_EPOCHS = 3
LDM_ARGS = ("--option", "edgez", "--bf16", "--max_face", "30", "--max_edge", "20",
            "--batch_size", "128", "--num_workers", "0")
# the remat "dots" step against remat "on": gradients per tensor within
# DOTS_REL of the tensor's largest plus DOTS_ABS of the overall largest (the
# train phase's bar; the two recompute the same arithmetic)
DOTS_REL, DOTS_ABS = 1e-3, 1e-5


def epoch_ms_per_step(metrics_path, skip=1):
    """(ms per step over the epochs after the first ``skip``, the logged
    losses, those epochs' records) from a training run's metrics file."""
    with open(metrics_path) as f:
        records = [json.loads(line) for line in f]
    epochs = [r for r in records if "epoch_seconds" in r][skip:]
    steps = sum(r["epoch_steps"] for r in epochs)
    ms = 1e3 * sum(r["epoch_seconds"] for r in epochs) / steps if steps else float("nan")
    return ms, [r["loss"] for r in records if "loss" in r], epochs


def distinct_rows(np, arrays):
    """The count of distinct grids among ``arrays`` [n, ...], taken in f32."""
    return len({row.tobytes() for a in arrays
                for row in np.ascontiguousarray(a, np.float32).reshape(len(a), -1)})


def phase_pipeline(torch, np, work):
    """process_main -> dedup_main x2 -> vae_main x2 -> ldm_main edgez with
    --cache_latents and --profile, then the same run without the cache, then
    --remat dots against --remat on; each CLI called as a user would, from
    ``work`` as the working directory."""
    import pickle
    import threading

    from brepgen_tpu_torch.cli import eval_main, ldm_main, process_main, vae_main
    from brepgen_tpu_torch.cli.build import build_denoiser, build_vae, seed_weights, uid_to_path
    from brepgen_tpu_torch.data.batch_assembly import assemble_edgez_batched
    from brepgen_tpu_torch.data.latent_cache import LatentCache
    from brepgen_tpu_torch.diffusion.ddpm import make_ddpm_tables
    from brepgen_tpu_torch.kernels import LAUNCH_COUNTS, reset_launch_counts
    from brepgen_tpu_torch.train import ldm_train, vae_train
    from brepgen_tpu_torch.train.checkpoint import load_params
    from brepgen_tpu_torch.train.common import TrainState, make_vae_optimizer
    from brepgen_tpu_torch.utils.profiling import (
        TRACE_FILE,
        device_trace,
        format_summary,
        summarize_trace,
    )

    out = {}
    cwd = os.getcwd()
    os.chdir(work)
    try:
        t = time.perf_counter()
        split_path = process_main.main(["--synthetic", str(PIPELINE_SOLIDS), "--output", "parsed",
                                        "--option", "deepcad"])
        with open(split_path, "rb") as f:
            split = pickle.load(f)
        lists = {kind: eval_main.dedup_main(["--data", "parsed", "--list", split_path, *extra])
                 for kind, extra in (("surface", []), ("edge", ["--edge"]))}
        counts = {}
        for kind, path in lists.items():
            with open(path, "rb") as f:
                counts[kind] = len(pickle.load(f))
        log(f"pipeline: process_main --synthetic {PIPELINE_SOLIDS}: "
            + ", ".join(f"{len(v)} {k}" for k, v in split.items())
            + f" solids; dedup_main: {counts['surface']} surfaces, {counts['edge']} edges; "
            f"{time.perf_counter() - t:.2f} s")
        out.update(solids={k: len(v) for k, v in split.items()}, dedup=counts)

        # the VAEs (train_vae.sh at production width in bf16); the edge set
        # is smaller than a 512 batch, where the drop-last epoch trains no
        # step, so its CLI run takes batches of 16
        packs, vae_rows = {}, {}
        for option, batch in (("surface", 512), ("edge", 16)):
            t = time.perf_counter()
            e = str(VAE_EPOCHS)
            state = vae_main.main([
                "--option", option, "--bf16", "--batch_size", str(batch), "--data", "parsed",
                "--train_list", lists[option], "--val_list", split_path, "--train_nepoch", e,
                "--test_nepoch", e, "--save_nepoch", e, "--dir_name", "vae", "--env", option])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t
            ms, losses, _ = epoch_ms_per_step(os.path.join("vae", option, f"{option}.jsonl"))
            packs[option] = os.path.join(work, "vae", option, f"epoch_{VAE_EPOCHS}.npz")
            fresh = load_params(packs[option], build_vae(option)).to("cuda")
            shape = (4, 4, 4, 3) if option == "surface" else (4, 4, 3)
            z = torch.randn(shape, generator=torch.Generator().manual_seed(0)).to("cuda")
            state.module.eval()
            with torch.no_grad():
                reload_diff = (fresh.decode(z) - state.module.decode(z)).abs().max().item()
            if (state.step < VAE_EPOCHS or reload_diff != 0.0 or not losses
                    or not np.isfinite(losses).all()):
                raise AssertionError(f"pipeline: {option} VAE: {state.step} steps, losses "
                                     f"{losses}, reloaded decode differs by {reload_diff}")
            vae_rows[option] = dict(steps=state.step, batch=batch, seconds=seconds,
                                    ms_per_step=ms, losses=losses)
            log(f"pipeline: vae_main --option {option} --bf16 --batch_size {batch}: "
                f"{state.step} steps in {seconds:.2f} s (whole run); {ms:.1f} ms per step "
                f"after the first epoch; losses " + ", ".join(f"{x:.5f}" for x in losses)
                + f"; epoch_{VAE_EPOCHS}.npz reloads strictly with a bit-equal decode")
            del state, fresh
            torch.cuda.empty_cache()

        # a B=512 train step of each VAE at production width (the edge set is
        # tiled to 512): timed over 5 steps after 2, then 2 steps traced
        for option in ("surface", "edge"):
            with open(lists[option], "rb") as f:
                grids = np.asarray(pickle.load(f), np.float32)
            batch = torch.from_numpy(np.resize(grids, (512,) + grids.shape[1:])).to("cuda")
            model = seed_weights(build_vae(option), torch.Generator().manual_seed(0)).to("cuda")
            state = TrainState(model, make_vae_optimizer(model.parameters()))
            step = vae_train.make_train_step(model, torch.bfloat16)
            gen = torch.Generator().manual_seed(1)
            for _ in range(2):
                step(state, batch, gen)
            torch.cuda.synchronize()
            t = time.perf_counter()
            losses = [step(state, batch, gen)["loss"] for _ in range(5)]
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t) / 5
            trace_dir = os.path.join(work, f"vae_trace_{option}")
            with device_trace(trace_dir):
                for _ in range(2):
                    step(state, batch, gen)
            summary = summarize_trace(os.path.join(trace_dir, TRACE_FILE))
            vae_rows[option].update(ms_per_step_b512=ms, trace_b512=summary)
            log(f"pipeline: {option} VAE train step at B=512, production width, bf16: "
                f"{ms:.2f} ms (5 steps after 2; losses "
                + ", ".join(f"{float(x):.5f}" for x in losses)
                + f"); 2 steps traced: {format_summary(summary)}")
            del model, state, step, batch
            torch.cuda.empty_cache()
        out["vae"] = vae_rows
        out.update(packs=packs, parsed=os.path.join(work, "parsed"))

        # the cached, profiled edgez run and the same run encoding in the step
        vae_args = ("--surfvae", packs["surface"], "--edgevae", packs["edge"])
        runs = {}
        for name, extra, epochs in (("cached", ("--cache_latents", "--profile", "trace"), 3),
                                    ("encoded", (), 2)):
            e = str(epochs)
            args = ldm_main.get_args([*LDM_ARGS, *vae_args, "--data", "parsed", "--list",
                                      split_path, "--train_nepoch", e, "--test_nepoch", e,
                                      "--save_nepoch", e, "--dir_name", "ldm", "--env", name,
                                      *extra])
            t = time.perf_counter()
            reset_launch_counts()
            run = ldm_main.train(args)
            torch.cuda.synchronize()
            launches = dict(LAUNCH_COUNTS)
            seconds = time.perf_counter() - t
            model, steps, val_calls = run.state.module, run.state.step, run.val_calls
            layers = model.encoder.num_layers
            want = dict(packed_attention_backward=layers * steps,
                        packed_attention=2 * layers * steps + layers * val_calls)
            others = {k: v for k, v in launches.items() if k not in want and v}
            if others or any(launches[k] != v for k, v in want.items()) or not val_calls:
                raise AssertionError(f"pipeline: {name}: {steps} steps, {val_calls} validation "
                                     f"calls; launches {launches}, expected {want}")
            ms, losses, epochs_rec = epoch_ms_per_step(run.metrics_path,
                                                       skip=2 if name == "cached" else 1)
            if not losses or not np.isfinite(losses).all():
                raise AssertionError(f"pipeline: {name}: losses {losses}")
            runs[name] = dict(steps=steps, val_calls=val_calls, seconds=seconds, ms_per_step=ms,
                              launches=launches["packed_attention_backward"],
                              k1_launches=launches["packed_attention"], losses=losses,
                              epoch_seconds=[r["epoch_seconds"] for r in epochs_rec])
            if name == "cached":
                cached_run = run
            del model
            log(f"pipeline: ldm_main {' '.join(LDM_ARGS)} {' '.join(extra)}: {steps} steps in "
                f"{seconds:.2f} s (whole run); {ms:.1f} ms per step over the last epoch"
                f"{'' if name == 'cached' else ' after the first'}; K5 launches "
                f"{launches['packed_attention_backward']} = {layers} x {steps}, K1 "
                f"{launches['packed_attention']} = 2 x {layers} x {steps} + {layers} x "
                f"{val_calls} validation calls")

        # the cache: every miss a distinct grid of the solids (or the padding's
        # zero grid), repeats hit
        grids = {"surf_ncs": [], "edge_ncs": []}
        for uid in split["train"] + split["val"]:
            with open(uid_to_path("parsed", uid), "rb") as f:
                data = pickle.load(f)
            for k in grids:
                grids[k].append(data[k])
        caches = dict(surface=cached_run.surf_cache, edge=cached_run.edge_cache)
        for (kind, cache), key in zip(caches.items(), grids):
            distinct = distinct_rows(np, grids[key]) + 1
            if not (0 < cache.misses <= distinct and cache.hits > 0):
                raise AssertionError(f"pipeline: {kind} cache: {cache.misses} misses against "
                                     f"{distinct} distinct grids, {cache.hits} hits")
        runs["cached"]["cache"] = {k: dict(hits=c.hits, misses=c.misses) for k, c in caches.items()}
        # the host's share: one step's lookups, all hits, on the host clock
        for (kind, cache), key, n in zip(caches.items(), grids, (128 * 30, 128 * 30 * 20)):
            flat = np.concatenate(grids[key]).astype(np.float32)
            rows = np.resize(flat, (n,) + flat.shape[1:])
            misses = cache.misses
            t = time.perf_counter()
            cache(rows)
            runs["cached"]["cache"][kind]["lookup_ms_per_step"] = 1e3 * (time.perf_counter() - t)
            if cache.misses != misses:
                raise AssertionError(f"pipeline: {kind} cache missed grids it had seen")

        # the trace: the device idle share of the traced window
        trace = cached_run.trace
        if trace is None or trace.path is None or not os.path.isfile(trace.path):
            raise AssertionError("pipeline: --profile wrote no trace")
        summary = summarize_trace(trace.path)
        if summary["device_idle_share"] is None or trace.first_step != 10 or trace.last_step < 16:
            raise AssertionError(f"pipeline: trace of steps {trace.first_step}-"
                                 f"{trace.last_step}: {summary}")
        # K5's and K1's kernels in the window: their share of device-busy time
        from brepgen_tpu_torch.kernels import KERNEL_FUNCTIONS
        with open(trace.path) as f:
            kernel_events = [e for e in json.load(f)["traceEvents"]
                             if e.get("ph") == "X" and e.get("cat") == "kernel"]
        n_steps = trace.last_step - trace.first_step + 1
        shares = {}
        for wrapper in ("packed_attention_backward", "packed_attention"):
            funcs = KERNEL_FUNCTIONS[wrapper][0]
            hit = [float(e["dur"]) for e in kernel_events if any(f in e["name"] for f in funcs)]
            shares[wrapper] = dict(ms=sum(hit) / 1e3, count=len(hit),
                                   share=sum(hit) / 1e3 / summary["device_busy_ms"],
                                   ms_per_step=sum(hit) / 1e3 / n_steps)
        runs["cached"]["trace"] = dict(summary, steps=[trace.first_step, trace.last_step],
                                       megabytes=os.path.getsize(trace.path) / 2 ** 20,
                                       kernel_shares=shares)
        log(f"pipeline: trace of steps {trace.first_step}-{trace.last_step} "
            f"({os.path.getsize(trace.path) / 2 ** 20:.1f} MB): {format_summary(summary)}; "
            + "; ".join(f"{w} kernels {v['ms']:.1f} ms x{v['count']}, {v['share']:.4f} of "
                        f"device-busy time, {v['ms_per_step']:.2f} ms a step"
                        for w, v in shares.items()))
        log(f"pipeline: edgez bf16 step with --cache_latents {runs['cached']['ms_per_step']:.1f} "
            f"ms, encoding in the step {runs['encoded']['ms_per_step']:.1f} ms; cache "
            + ", ".join(f"{k} {v['hits']} hits / {v['misses']} misses, one step's lookups "
                        f"{v['lookup_ms_per_step']:.1f} ms on the host"
                        for k, v in runs["cached"]["cache"].items()))

        # the cache's latents, encoded in a thread of its own as the batch
        # producer does, against the step's encode under the step's autocast
        edge_encode = vae_train.make_encoder_fn(ldm_main.load_vae("edge", packs["edge"], "cuda"),
                                                torch.bfloat16)
        flat = np.concatenate(grids["edge_ncs"]).astype(np.float32)
        rows = flat[np.unique(flat.reshape(len(flat), -1), axis=0, return_index=True)[1]]
        rows = np.resize(rows, (1024,) + rows.shape[1:])
        cache = LatentCache(edge_encode, (32, 3), 12, bucket=1024, device="cuda")
        held = {}
        worker = threading.Thread(target=lambda: held.update(z=cache(rows)))
        worker.start()
        worker.join()
        with torch.autocast("cuda", dtype=torch.bfloat16):
            z_step = edge_encode(torch.from_numpy(rows).to("cuda")).reshape(1024, 12).cpu().numpy()
        f32 = vae_train.make_encoder_fn(ldm_main.load_vae("edge", packs["edge"], "cuda"))
        z_f32 = f32(torch.from_numpy(rows).to("cuda")).reshape(1024, 12).cpu().numpy()
        cache_diff = float(np.abs(held["z"] - z_step).max())
        f32_diff = float(np.abs(z_f32 - z_step).max())
        if cache_diff > 1e-6:
            raise AssertionError(f"pipeline: the cache's latents differ from the step's encode "
                                 f"by {cache_diff:.3e} (an f32 encode differs by {f32_diff:.3e})")
        log(f"pipeline: cache latents encoded in a producer thread against the step's bf16 "
            f"encode: max abs diff {cache_diff:.3e} (the same grids encoded in f32 differ by "
            f"{f32_diff:.3e})")
        runs["cached"].update(latent_max_abs_diff=cache_diff, latent_f32_max_abs_diff=f32_diff)
        out["ldm"] = runs
        del cached_run, edge_encode, f32
        torch.cuda.empty_cache()

        # --remat dots against --remat on: one f32 edgez step at production
        # width, B=128, the same parameters, batch, draws and dropout seeds
        solids = []
        for uid in split["train"][:128]:
            with open(uid_to_path("parsed", uid), "rb") as f:
                solids.append(pickle.load(f))
        raw = assemble_edgez_batched(solids, list(range(128)), max_face=30, max_edge=20)
        batch = {k: torch.from_numpy(v).to("cuda")
                 for k, v in zip(ldm_main.BATCH_KEYS["edgez"], raw)}
        # the latents enter the batch, as with --cache_latents, so the peak
        # memory is the denoiser's and not the frozen encoders'
        encode = {o: vae_train.make_encoder_fn(ldm_main.load_vae(o, packs[o], "cuda"))
                  for o in ("surface", "edge")}
        batch["surfz"] = ldm_train.encode_surf(encode["surface"], batch.pop("surfpnt"))
        batch["edgez"] = ldm_train.encode_edge(encode["edge"], batch.pop("edgepnt"))
        del encode
        torch.cuda.empty_cache()
        grads = {}
        for remat in (True, "dots"):
            net = build_denoiser("edgez", remat=remat)
            layers = net.encoder.num_layers
            net = seed_weights(net, torch.Generator().manual_seed(2)).to("cuda")
            step = ldm_train.make_edgez_step(net, make_ddpm_tables(), None, None)
            capture = GradCapture(net)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            loss = float(step(TrainState(net, capture), batch, torch.Generator().manual_seed(3))
                         ["loss"])
            torch.cuda.synchronize()
            grads[remat] = dict(grads=capture.grads, loss=loss, launches=dict(LAUNCH_COUNTS),
                                peak_bytes=torch.cuda.max_memory_allocated())
            t = time.perf_counter()  # a second step from the same state, timed
            step(TrainState(net, capture), batch, torch.Generator().manual_seed(3))
            torch.cuda.synchronize()
            grads[remat]["seconds"] = time.perf_counter() - t
            del net, step, capture
            torch.cuda.empty_cache()
        on, dots = grads[True], grads["dots"]
        overall = max(g.abs().max().item() for g in on["grads"].values())
        worst, worst_name = max(
            ((dots["grads"][k] - g).abs().max().item()
             / (DOTS_REL * g.abs().max().item() + DOTS_ABS * overall), k)
            for k, g in on["grads"].items())
        if (set(on["grads"]) != set(dots["grads"]) or worst > 1.0
                or on["launches"] != dots["launches"]
                or on["launches"]["packed_attention"] != 2 * layers):
            raise AssertionError(f"pipeline: remat dots against on: worst tensor {worst_name} "
                                 f"at {worst:.3e} of its bar, launches {on['launches']} / "
                                 f"{dots['launches']}, losses {on['loss']} / {dots['loss']}")
        out["remat"] = {name: dict(loss=g["loss"], peak_gib=g["peak_bytes"] / 2 ** 30,
                                   seconds=g["seconds"], k1_launches=g["launches"]["packed_attention"])
                        for name, g in (("on", on), ("dots", dots))}
        out["remat"]["worst_share_of_bar"] = worst
        log(f"pipeline: f32 edgez step at B=128 S=600, remat dots against on: loss "
            f"{dots['loss']:.6f} / {on['loss']:.6f}, worst tensor {worst_name} at "
            f"{worst:.3e} of its bar ({DOTS_REL:g} of its largest + {DOTS_ABS:g} of the "
            f"overall largest); K1 launches {dots['launches']['packed_attention']} each; peak "
            f"memory {dots['peak_bytes'] / 2 ** 30:.2f} GiB dots, {on['peak_bytes'] / 2 ** 30:.2f}"
            f" GiB on; second step {dots['seconds']:.3f} s / {on['seconds']:.3f} s")
    finally:
        os.chdir(cwd)
    return out


# Phase step: STEP ingestion on the card's host, then training on what it
# read. A tenth of the pipeline's 2300 synthetic solids go out as STEP files
# through the port's writer and come back through the shard driver, in 4
# shards of process_main subprocesses, within STEP_TOL of their source grids
# (the JAX package's bar, tests/test_geometry.py:206); 3 epochs of edgez on
# them (192 train solids: one step of B=128 an epoch, drop_last)
STEP_SOLIDS = 240
STEP_SHARDS = 4
STEP_EPOCHS = 3
STEP_TOL = 5e-2


def phase_step(torch, np, solids_dir, solid_steps, work, pipeline):
    """(a) every STEP file phase solids and the overlap wrote passes the port's
    conformance validator, and each one of a solid ``validate_solid``; (b)
    ``STEP_SOLIDS`` of the pipeline's solids written as ``<id:08d>.step``
    through ``construct_brep(...).write_step``; (c) the tree extracted by
    ``shard_driver.process_shards_main`` (no retries, so no fault hides), one
    pkl per file within ``STEP_TOL`` of its source; (d) a split of those pkls,
    ``eval_main dedup`` of its surfaces and edges, and ``ldm_main`` edgez in
    bf16 at production width on them with the pipeline's VAE packs, K1 and K5
    launches held to the steps."""
    import pickle

    from brepgen_tpu_torch.cli import eval_main, ldm_main, process_main, shard_driver
    from brepgen_tpu_torch.cli.build import uid_to_path
    from brepgen_tpu_torch.geometry import construct_brep, load_brep, validate_solid
    from brepgen_tpu_torch.geometry.step_conformance import validate_step_file
    from brepgen_tpu_torch.kernels import LAUNCH_COUNTS, reset_launch_counts

    out = {}
    t_phase = t = time.perf_counter()
    files = sorted(os.path.join(d, f) for d, _, names in os.walk(solids_dir)
                   for f in names if f.endswith(".step"))
    checked = set()
    for path in files:
        errs = validate_step_file(path)
        if errs:
            raise AssertionError(f"step: {path} has {len(errs)} conformance violations: "
                                 f"{errs[:5]}")
        with open(path) as f:
            if "MANIFOLD_SOLID_BREP" not in f.read():
                continue
        report = validate_solid(load_brep(path))
        if not report["ok"]:
            raise AssertionError(f"step: validate_solid({path}): {report}")
        checked.add(path)
    missing = sorted(set(solid_steps) - checked)
    if missing or not checked:
        raise AssertionError(f"step: solids of phase solids not checked as solids: {missing}; "
                             f"{len(checked)} solid files among {len(files)}")
    seconds = time.perf_counter() - t
    out["validated"] = dict(files=len(files), solids=len(checked), seconds=seconds,
                            seconds_per_file=seconds / len(files))
    log(f"step: (a) {len(files)} STEP files of phases solids and overlap conformant, "
        f"{len(checked)} of them solids with validate_solid ok; {seconds:.2f} s, "
        f"{seconds / len(files):.4f} s per file on the host")

    t = time.perf_counter()
    parsed = pipeline["parsed"]
    uids = sorted(os.listdir(os.path.join(parsed, "0000")))[:STEP_SOLIDS]
    tree = os.path.join(work, "steps")
    os.makedirs(tree)
    sources = {}
    for uid in uids:
        with open(uid_to_path(parsed, uid), "rb") as f:
            data = pickle.load(f)
        solid = construct_brep(data["surf_wcs"], data["edge_wcs"], data["faceEdge_adj"],
                               data["edgeCorner_adj"])
        if not solid.topology_ok():
            raise AssertionError(f"step: source solid {uid} does not close into a shell")
        solid.write_step(os.path.join(tree, uid.replace(".pkl", ".step")))
        sources[uid] = data["surf_wcs"]
    seconds = time.perf_counter() - t
    out["written"] = dict(files=len(uids), seconds=seconds, seconds_per_solid=seconds / len(uids))
    log(f"step: (b) {len(uids)} of the pipeline's solids written as STEP through "
        f"construct_brep(...).write_step in {seconds:.2f} s, {seconds / len(uids):.4f} s per "
        f"solid on the host")

    # (c) each shard a `python -m brepgen_tpu_torch.cli.process_main`
    # subprocess, which imports the package from this checkout
    t = time.perf_counter()
    extracted = os.path.join(work, "extracted")
    env_path = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = os.pathsep.join(p for p in (ROOT, env_path) if p)
    try:
        manifest = shard_driver.process_shards_main([
            "--input", tree, "--output", extracted, "--option", "furniture", "--shard_size",
            str(-(-len(uids) // STEP_SHARDS)), "--timeout", "300", "--retries", "0"])
    finally:
        if env_path is None:
            del os.environ["PYTHONPATH"]
        else:
            os.environ["PYTHONPATH"] = env_path
    seconds = time.perf_counter() - t
    pkls = sorted(f for _, _, names in os.walk(extracted) for f in names if f.endswith(".pkl"))
    if (manifest["done"] != list(range(STEP_SHARDS)) or manifest["failed"]
            or pkls != sorted(uids)):
        raise AssertionError(f"step: shard manifest {manifest}; {len(pkls)} pkls for "
                             f"{len(uids)} STEP files")
    worst = 0.0
    for uid in pkls:
        with open(uid_to_path(extracted, uid), "rb") as f:
            got = pickle.load(f)["surf_wcs"]
        if got.shape != sources[uid].shape:
            raise AssertionError(f"step: {uid}: surf_wcs {got.shape} from STEP, "
                                 f"{sources[uid].shape} in the source")
        worst = max(worst, float(np.abs(got - sources[uid]).max()))
    if not worst < STEP_TOL:
        raise AssertionError(f"step: extracted surf_wcs off its source by {worst:.3e}")
    out["extracted"] = dict(files=len(pkls), shards=STEP_SHARDS, seconds=seconds,
                            seconds_per_solid=seconds / len(pkls), surf_wcs_max_abs_diff=worst)
    log(f"step: (c) shard_driver over {len(uids)} STEP files in {STEP_SHARDS} shards "
        f"(process_main subprocesses): done {manifest['done']}, failed {manifest['failed']}, "
        f"{len(pkls)} pkls in {seconds:.2f} s, {seconds / len(pkls):.4f} s per extracted solid "
        f"on the host; surf_wcs within {worst:.3e} of the source grids (bar {STEP_TOL:g})")

    # (d) train on the extracted pkls, from a directory of its own
    t = time.perf_counter()
    cwd = os.getcwd()
    os.makedirs(os.path.join(work, "train"))
    os.chdir(os.path.join(work, "train"))
    try:
        split_path = "deepcad_data_split_6bit.pkl"
        split = process_main.split_uids(pkls, 0)
        with open(split_path, "wb") as f:
            pickle.dump(split, f)
        counts = {}
        for kind, extra in (("surface", []), ("edge", ["--edge"])):
            with open(eval_main.dedup_main(["--data", extracted, "--list", split_path, *extra]),
                      "rb") as f:
                counts[kind] = len(pickle.load(f))
        e = str(STEP_EPOCHS)
        args = ldm_main.get_args([
            *LDM_ARGS, "--surfvae", pipeline["packs"]["surface"], "--edgevae",
            pipeline["packs"]["edge"], "--data", extracted, "--list", split_path,
            "--train_nepoch", e, "--test_nepoch", e, "--save_nepoch", e, "--dir_name", "ldm",
            "--env", "step"])
        reset_launch_counts()
        run = ldm_main.train(args)
        torch.cuda.synchronize()
        launches = dict(LAUNCH_COUNTS)
        train_seconds = time.perf_counter() - t
        ms, losses, _ = epoch_ms_per_step(run.metrics_path)
    finally:
        os.chdir(cwd)
    steps, val_calls = run.state.step, run.val_calls
    layers = run.state.module.encoder.num_layers
    want = dict(packed_attention_backward=layers * steps,
                packed_attention=2 * layers * steps + layers * val_calls)
    others = {k: v for k, v in launches.items() if k not in want and v}
    if (steps < STEP_EPOCHS or not val_calls or others
            or any(launches[k] != v for k, v in want.items())
            or not losses or not np.isfinite(losses).all()):
        raise AssertionError(f"step: ldm_main on the extracted pkls: {steps} steps, {val_calls} "
                             f"validation calls, launches {launches}, expected {want}, losses "
                             f"{losses}")
    out["train"] = dict(split={k: len(v) for k, v in split.items()}, dedup=counts, steps=steps,
                        val_calls=val_calls, seconds=train_seconds, ms_per_step=ms,
                        launches=launches["packed_attention_backward"],
                        k1_launches=launches["packed_attention"], losses=losses)
    log(f"step: (d) split {out['train']['split']}, dedup_main {counts['surface']} surfaces, "
        f"{counts['edge']} edges; ldm_main {' '.join(LDM_ARGS)} on the extracted pkls: {steps} "
        f"steps in {train_seconds:.2f} s (whole run); K5 launches "
        f"{launches['packed_attention_backward']} = {layers} x {steps}, K1 "
        f"{launches['packed_attention']} = 2 x {layers} x {steps} + {layers} x {val_calls} "
        f"validation calls; losses " + ", ".join(f"{x:.5f}" for x in losses))
    out["seconds"] = time.perf_counter() - t_phase
    del run
    return out


# Phase dp: multi-GPU on the one card. (a) ldm_main --dp under torchrun at
# world size 1 over NCCL against the same command without --dp; (b)-(d) two
# ranks of this script sharing the card over gloo (NCCL refuses two ranks on
# one device): a split edgez step, split sampling and the tensor-parallel
# forward, each against one process; (e) convert_torch on a production-width
# reference-layout checkpoint. The bars are the JAX package's
# (tests/test_parallel.py): loss rtol 1e-5 and parameters 2.5e-4 after one
# step (:37-65), the tensor-parallel forward rtol 2e-4 atol 2e-5 (:68-87),
# split sampling 1e-4 (:102-117). The parameter bar holds where the
# gradient is resolved: the single-process gradient exceeds DP_LIVE_GRAD and
# the two runs' difference. Elsewhere both runs hold rounding noise (the
# attention's key bias, whose exact gradient is zero; sums that cancel to
# ~1e-7), and Adam's first step, lr * g / (|g| + eps), moves an element by
# up to lr either way: those are held to 2 lr, as
# tests/test_torch_port_train.py holds them; the gradients themselves are
# held to GRAD_REL of their norm, the train phase's bar for the same
# arithmetic in another order. abc compacted on the all160k packs is held
# to COMPACT_TOL: the split changes the products' row counts, so f32 sums in
# another order through 20 denoiser calls of trained weights.
DP_EPOCHS = 3
# 200 synthetic solids: one step of B=128 an epoch (drop_last)
DP_ARGS = ("--option", "edgez", "--bf16", "--max_face", "30", "--max_edge", "20",
           "--batch_size", "128", "--synthetic", "200", "--num_workers", "0",
           "--train_nepoch", str(DP_EPOCHS), "--test_nepoch", str(DP_EPOCHS), "--save_nepoch",
           str(DP_EPOCHS), "--log_every", "1", "--env", "edgez")
DP_LOSS_RTOL, DP_PARAM_ATOL = 1e-5, 2.5e-4
DP_LIVE_GRAD, DP_LR = 1e-6, 5e-4
DP_SAMPLE_TOL = 1e-4
TP_RTOL, TP_ATOL = 2e-4, 2e-5
DP_STEP_BATCH, DP_SAMPLE_STEPS = 128, 4
DP_WORKER_TIMEOUT = 400


def launches_line(text):
    """The kernel launch counts, steps and validation calls ldm_main prints."""
    m = re.search(r"trained edgez: (\d+) steps and (\d+) validation calls .* kernel launches"
                  r"(?: on each of \d+ ranks)? (\{.*\})", text)
    if m is None:
        raise AssertionError(f"dp: no 'trained' line in the CLI's output: {text[-2000:]}")
    return int(m.group(1)), int(m.group(2)), json.loads(m.group(3))


def reference_layout(model):
    """``model``'s weights under the reference denoiser's names (the names
    ``tools/convert_torch.py`` reads): stream MLPs ``<ref>.{0,1,3}``,
    ``time_embed``, ``fc_out``, ``net.layers.<i>`` of a torch
    ``nn.TransformerEncoder`` with packed ``in_proj`` and ``net.norm``."""
    from brepgen_tpu_torch.tools.convert_torch import STREAM_MAPS

    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    ref = {}
    mlps = dict(STREAM_MAPS["edgez"], time_embed="time_embed", head="fc_out")
    for ours, theirs in mlps.items():
        for i, name in ((0, "fc1"), (1, "norm"), (3, "fc2")):
            for leaf in ("weight", "bias"):
                ref[f"{theirs}.{i}.{leaf}"] = sd[f"{ours}.{name}.{leaf}"]
    for i in range(model.encoder.num_layers):
        lp, ours = f"net.layers.{i}", f"encoder.layer_{i}"
        ref[f"{lp}.self_attn.in_proj_weight"] = sd[f"{ours}.attn.qkv.weight"]
        ref[f"{lp}.self_attn.in_proj_bias"] = sd[f"{ours}.attn.qkv.bias"]
        for theirs, name in (("self_attn.out_proj", "attn.proj"), ("norm1", "norm1"),
                             ("norm2", "norm2"), ("linear1", "fc1"), ("linear2", "fc2")):
            for leaf in ("weight", "bias"):
                ref[f"{lp}.{theirs}.{leaf}"] = sd[f"{ours}.{name}.{leaf}"]
    for leaf in ("weight", "bias"):
        ref[f"net.norm.{leaf}"] = sd[f"encoder.final_norm.{leaf}"]
    if len(ref) != len(sd):
        raise AssertionError(f"convert: {len(ref)} reference tensors for {len(sd)} parameters")
    return ref


def edgez_probe(torch, model, seed):
    """Streams, timesteps and a mask at the deepcad training shape (B=2, S=600)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    streams = [torch.randn((2, 600, d), generator=gen, device="cuda")
               for d in model.stream_dims.values()]
    mask = torch.zeros((2, 600), dtype=torch.bool, device="cuda")
    mask[1, 300:] = True
    return streams, torch.tensor([5, 600], device="cuda"), mask


def phase_dp(torch, np, work):
    """(a) and (e) here, (b)-(d) in two worker processes of this script."""
    from brepgen_tpu_torch.cli.build import build_denoiser, seed_weights
    from brepgen_tpu_torch.kernels import LAUNCH_COUNTS, reset_launch_counts
    from brepgen_tpu_torch.train.checkpoint import load_params

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    vaes = ("--surfvae", os.path.join(PACKS, "surf_vae.npz"),
            "--edgevae", os.path.join(PACKS, "edge_vae.npz"))
    t0 = time.perf_counter()
    # (a) the CLI: --dp under torchrun (NCCL, world size 1), then the same
    # command without --dp (one after the other: their ms per step compare)
    cmds = {
        "dp": [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", "1", "-m", "brepgen_tpu_torch.cli.ldm_main", *DP_ARGS, *vaes,
               "--dp", "--dir_name", os.path.join(work, "dp")],
        "one": [sys.executable, "-m", "brepgen_tpu_torch.cli.ldm_main", *DP_ARGS, *vaes,
                "--dir_name", os.path.join(work, "one")],
    }
    outs = {}
    for k, c in cmds.items():
        proc = subprocess.run(c, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, timeout=DP_WORKER_TIMEOUT)
        if proc.returncode != 0:
            raise AssertionError(f"dp (a): ldm_main ({k}) exited {proc.returncode}: "
                                 f"{proc.stdout[-3000:]}")
        outs[k] = proc.stdout
    a_seconds = time.perf_counter() - t0
    steps, val_calls, counts = launches_line(outs["dp"])
    layers = 12
    want = dict(packed_attention_backward=layers * steps,
                packed_attention=2 * layers * steps + layers * val_calls)
    if steps < DP_EPOCHS or val_calls < 1 or any(counts[k] != v for k, v in want.items()) or \
            any(v for k, v in counts.items() if k not in want):
        raise AssertionError(f"dp (a): {steps} steps, {val_calls} validation calls; launches "
                             f"{counts}, expected {want}")
    if launches_line(outs["one"])[2] != counts:
        raise AssertionError(f"dp (a): launches without --dp {launches_line(outs['one'])[2]}")
    records = {}
    for k in cmds:
        with open(os.path.join(work, k, "edgez", "edgez.jsonl")) as f:
            records[k] = [json.loads(line) for line in f]
    keys = ("loss", "loss_z", "loss_v")
    losses = {k: [[r[m] for m in keys] for r in rs if "loss" in r] for k, rs in records.items()}
    vals = {k: {m: v for r in rs for m, v in r.items() if m.startswith("Val-")}
            for k, rs in records.items()}
    if len(losses["dp"]) != steps or not np.allclose(losses["dp"], losses["one"],
                                                       rtol=DP_LOSS_RTOL, atol=0) \
            or sorted(vals["dp"]) != sorted(vals["one"]) or not all(
                np.isclose(vals["dp"][m], v, rtol=DP_LOSS_RTOL, atol=0)
                for m, v in vals["one"].items()):
        raise AssertionError(f"dp (a): losses {losses}, validation {vals}")
    bit_equal = losses["dp"] == losses["one"] and vals["dp"] == vals["one"]
    packs = {k: os.path.join(work, k, "edgez", f"epoch_{DP_EPOCHS}.npz") for k in cmds}
    fresh = {k: load_params(p, build_denoiser("edgez")) for k, p in packs.items()}
    pack_diff = max((fresh["dp"].state_dict()[n] - v).abs().max().item()
                    for n, v in fresh["one"].state_dict().items())
    if pack_diff > DP_PARAM_ATOL:
        raise AssertionError(f"dp (a): the --dp pack differs from the other by {pack_diff:.3e}")
    steady = {k: [r for r in rs if "epoch_seconds" in r][1:] for k, rs in records.items()}
    ms = {k: 1e3 * sum(r["epoch_seconds"] for r in rs) / sum(r["epoch_steps"] for r in rs)
          for k, rs in steady.items()}
    del fresh
    agree = "bit-equal" if bit_equal else f"equal within {DP_LOSS_RTOL}"
    per_step = ", ".join(f"{x[0]:.6f}" for x in losses["dp"])
    log(f"dp (a): torchrun --nproc_per_node 1 ldm_main --dp (NCCL) and ldm_main without --dp, "
        f"edgez bf16 B=128 S=600 W=768, {steps} steps + {val_calls} validation calls in "
        f"{a_seconds:.2f} s (both): per-step losses {agree} ({per_step}), validation equal; "
        f"launches {counts} = "
        f"12 K5 and 24 K1 a step + 12 K1 a validation call; the rank-0 npz loads strictly into "
        f"build_denoiser, max abs diff to the pack without --dp {pack_diff:g}; ms per step after "
        f"the first {ms['dp']:.1f} (--dp) / {ms['one']:.1f}")
    result = dict(a=dict(steps=steps, val_calls=val_calls, launches=counts, bit_equal=bit_equal,
                         losses=losses["dp"], pack_max_abs_diff=pack_diff, ms_per_step=ms,
                         seconds=a_seconds))

    # (b)-(d) in two ranks over gloo on this card; (e) here meanwhile
    t0 = time.perf_counter()
    init = f"file://{os.path.join(work, 'rendezvous')}"
    ranks = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dp_worker", str(r),
                               "--dp_init", init, "--dp_out",
                               os.path.join(work, f"rank{r}.json")],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in (0, 1)]
    try:
        model = seed_weights(build_denoiser("edgez"), torch.Generator().manual_seed(6)).eval()
        pt = os.path.join(work, "edgez_reference.pt")
        torch.save(reference_layout(model), pt)
        npz = os.path.join(work, "converted", "edgez.npz")
        conv = subprocess.run([sys.executable, "-m", "brepgen_tpu_torch.tools.convert_torch",
                               "--input", pt, "--kind", "edgez", "--output", npz], cwd=ROOT,
                              env=env, capture_output=True, text=True, timeout=300)
        if conv.returncode != 0:
            raise AssertionError(f"dp (e): convert_torch exited {conv.returncode}: "
                                 f"{conv.stdout[-2000:]}{conv.stderr[-2000:]}")
        converted = load_params(npz, build_denoiser("edgez")).to("cuda").eval()
        model = model.to("cuda")
        probe = edgez_probe(torch, model, 7)
        with torch.no_grad():
            want_e = model(*probe)
            reset_launch_counts()
            got_e = converted(*probe)
            torch.cuda.synchronize()
            e_counts = dict(LAUNCH_COUNTS)
        e_diff = (got_e - want_e).abs().max().item()
        if e_diff != 0.0 or e_counts["packed_attention"] != 12:
            raise AssertionError(f"dp (e): converted forward differs by {e_diff:.3e}; launches "
                                 f"{e_counts}")
        log(f"dp (e): convert_torch --kind edgez on a production-width reference-layout .pt "
            f"({os.path.getsize(pt) / 2**20:.1f} MiB) -> npz loaded strictly; its forward "
            f"(B=2, S=600) through K1 ({e_counts['packed_attention']} launches) equals the "
            f"source module's bit for bit")
        result["e"] = dict(launches=e_counts["packed_attention"], max_abs_diff=e_diff)
        del model, converted, want_e, got_e
        torch.cuda.empty_cache()
    finally:
        logs = [p.communicate(timeout=DP_WORKER_TIMEOUT)[0] for p in ranks]
    for r, (p, text) in enumerate(zip(ranks, logs)):
        if p.returncode != 0:
            raise AssertionError(f"dp: worker rank {r} exited {p.returncode}: {text[-4000:]}")
    with open(os.path.join(work, "rank0.json")) as f:
        result.update(json.load(f))
    for line in logs[0].splitlines():  # rank 0's result lines, on the worker's clock
        if re.match(r"\[ *[\d.]+ s\] dp \(", line):
            print(f"{line} (rank 0's clock)", flush=True)
    log(f"dp (b)-(e) done in {time.perf_counter() - t0:.2f} s (two workers and the conversion "
        f"together)")
    return result


def dp_worker(torch, np, rank, init, out):
    """Rank ``rank`` of two sharing card 0 over gloo: (b) a split edgez step,
    (c) split sampling, (d) the tensor-parallel forward; rank 0 also runs
    each single-process reference and writes the comparisons to ``out``."""
    import torch.distributed as dist

    from brepgen_tpu_torch.cli import ldm_main
    from brepgen_tpu_torch.cli.build import build_denoiser, seed_weights
    from brepgen_tpu_torch.cli.sample_main import init_cascade, sample_loop
    from brepgen_tpu_torch.data.batch_assembly import assemble_edgez_batched
    from brepgen_tpu_torch.data.synthetic import make_dataset
    from brepgen_tpu_torch.diffusion.ddpm import make_ddpm_tables
    from brepgen_tpu_torch.kernels import LAUNCH_COUNTS, reset_launch_counts
    from brepgen_tpu_torch.parallel import make_mesh, replicate
    from brepgen_tpu_torch.parallel.distributed import RowSplit
    from brepgen_tpu_torch.parallel.sharding_rules import shard_denoiser
    from brepgen_tpu_torch.train import ldm_train
    from brepgen_tpu_torch.train.common import TrainState, make_ldm_optimizer
    from brepgen_tpu_torch.train.vae_train import make_encoder_fn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=2)
    split = RowSplit.of_group()
    main_rank = rank == 0
    res = {}

    # (b) one f32 edgez step, global B=128 (64 a rank), the halves holding
    # different counts of valid edges, against the single-process step
    ds = make_dataset(DP_STEP_BATCH, seed=5)
    raw = assemble_edgez_batched(ds, list(range(DP_STEP_BATCH)), max_face=30, max_edge=20)
    batch = dict(zip(ldm_main.BATCH_KEYS["edgez"], raw))
    order = np.argsort((~batch["edge_mask"]).sum(axis=(1, 2)), kind="stable")
    batch = {k: torch.from_numpy(np.ascontiguousarray(v[order])).to("cuda")
             for k, v in batch.items()}
    valid = [int((~s.take(batch["edge_mask"].cpu())).sum()) for s in
             (RowSplit(0, 2), RowSplit(1, 2))]
    encode = [make_encoder_fn(ldm_main.load_vae(o, os.path.join(PACKS, f), "cuda"))
              for o, f in (("surface", "surf_vae.npz"), ("edge", "edge_vae.npz"))]
    tables = make_ddpm_tables()

    def one_step(row_split):
        model = seed_weights(build_denoiser("edgez", remat=True),
                             torch.Generator().manual_seed(2)).to("cuda")
        state = TrainState(model, make_ldm_optimizer(model.parameters()))
        net, rows = model, batch
        if row_split is not None:
            model.encoder.row_split = row_split
            net = torch.nn.parallel.DistributedDataParallel(model, device_ids=[0])
            rows = {k: row_split.take(v) for k, v in batch.items()}
        step = ldm_train.make_edgez_step(net, tables, *encode, row_split=row_split)
        torch.cuda.synchronize()
        reset_launch_counts()
        t = time.perf_counter()
        metrics = step(state, rows, torch.Generator().manual_seed(3))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        # the clipped gradient, read back from AdamW's first moment (1 - b1) g
        moments = state.optimizer.adamw.state
        grads = {n: moments[p]["exp_avg"] / (1 - 0.95) for n, p in model.named_parameters()}
        return (model, {k: float(v) for k, v in metrics.items()}, dict(LAUNCH_COUNTS), seconds,
                grads)

    model, metrics, counts, step_s, split_grads = one_step(split)
    if counts["packed_attention_backward"] != 12 or counts["packed_attention"] != 24:
        raise AssertionError(f"dp (b): rank {rank} launches {counts}")
    n_params = sum(p.numel() for p in model.parameters())
    flat = torch.zeros(n_params, device="cuda")
    reduce_ms = []
    for _ in range(3):
        dist.barrier()
        torch.cuda.synchronize()
        t = time.perf_counter()
        dist.all_reduce(flat)
        torch.cuda.synchronize()
        reduce_ms.append(1e3 * (time.perf_counter() - t))
    if main_rank:
        split_params = {k: v.detach().clone() for k, v in model.named_parameters()}
        del model
        torch.cuda.empty_cache()
        ref, ref_metrics, ref_counts, ref_s, ref_grads = one_step(None)
        loss_rel = {k: abs(metrics[k] - v) / abs(v) for k, v in ref_metrics.items()}
        norm = lambda ts: torch.sqrt(sum((t.double() ** 2).sum() for t in ts)).item()  # noqa: E731
        grad_rel = norm(split_grads[k] - g for k, g in ref_grads.items()) / norm(
            ref_grads.values())
        live_diff = dead_diff = 0.0
        dead = 0
        for k, v in ref.named_parameters():
            diff = (split_params[k] - v.detach()).abs()
            g = ref_grads[k].abs()
            live = (g > DP_LIVE_GRAD) & (g > (split_grads[k] - ref_grads[k]).abs())
            dead += int((~live).sum())
            live_diff = max(live_diff, diff[live].max().item() if live.any() else 0.0)
            dead_diff = max(dead_diff, diff[~live].max().item() if (~live).any() else 0.0)
        if max(loss_rel.values()) > DP_LOSS_RTOL or grad_rel > GRAD_REL \
                or live_diff > DP_PARAM_ATOL or dead_diff > 2 * DP_LR:
            raise AssertionError(f"dp (b): losses {metrics} / {ref_metrics} (relative "
                                 f"{loss_rel}), gradients' global relative difference "
                                 f"{grad_rel:.3e}, parameters max abs diff {live_diff:.3e} where "
                                 f"the gradient is resolved, {dead_diff:.3e} at the {dead} others")
        del ref, split_params, ref_grads
        param_diff = live_diff
        res["b"] = dict(launches=counts, valid_edges=valid, loss=metrics["loss"],
                        ref_loss=ref_metrics["loss"], loss_rel=max(loss_rel.values()),
                        param_max_abs_diff=param_diff, param_max_abs_diff_unresolved=dead_diff,
                        unresolved_elements=dead, grad_rel=grad_rel,
                        step_s=step_s, ref_step_s=ref_s,
                        allreduce_ms=sum(reduce_ms) / len(reduce_ms), params=n_params)
        log(f"dp (b): edgez f32 step, B=128 split 64/64 over 2 gloo ranks on one card (valid "
            f"edges {valid[0]} / {valid[1]}), DDP: loss {metrics['loss']:.7f} against "
            f"{ref_metrics['loss']:.7f} in one process (relative {max(loss_rel.values()):.2e}, "
            f"bar {DP_LOSS_RTOL:g}), clipped gradients' global relative difference "
            f"{grad_rel:.3e} (bar {GRAD_REL:g}), parameters after one AdamW step max abs diff "
            f"{param_diff:.3e} where the gradient is resolved (bar {DP_PARAM_ATOL:g}), "
            f"{dead_diff:.3e} at the {dead} of {n_params} elements where it is not (bar 2 lr = "
            f"{2 * DP_LR:g}); K5 {counts['packed_attention_backward']} "
            f"and K1 {counts['packed_attention']} a rank; step {1e3 * step_s:.1f} ms split, "
            f"{1e3 * ref_s:.1f} ms whole; gloo all-reduce of the {n_params} f32 gradients "
            f"({4 * n_params / 2**20:.1f} MiB) {res['b']['allreduce_ms']:.1f} ms a step (mean "
            f"of 3: two ranks sharing one card through host memory, not a multi-card number)")
    else:
        del model
    torch.cuda.empty_cache()
    dist.barrier()

    # (c) split sampling: deepcad seeded at production width, f32, B=16 (8 a
    # rank), DDIM 4; abc compacted on the all160k packs, B=4 (2 a rank)
    for name, mode, packs, batch_size, over, tol in (
            ("deepcad", "deepcad", None, 16, {"fast_steps": DP_SAMPLE_STEPS}, DP_SAMPLE_TOL),
            ("abc_compact", "abc", PACKS, 4, {"fast_steps": ABC_STEPS, "compact": True},
             COMPACT_TOL)):
        cascade = init_cascade(mode, packs, batch_size=batch_size, device="cuda",
                               step_overrides=over, row_split=split)
        reset_launch_counts()
        run = sample_loop(cascade, max_batches=1, postprocess=False)
        torch.cuda.synchronize()
        k1 = LAUNCH_COUNTS["packed_attention"]
        buckets = [None, None]
        dist.all_gather_object(buckets, cascade.last_bucket)
        del cascade
        if main_rank:
            single = init_cascade(mode, packs, batch_size=batch_size, device="cuda",
                                  step_overrides=over)
            want = sample_loop(single, max_batches=1, postprocess=False).batches[0]
            bucket = single.last_bucket
            del single
            got = run.batches[0]
            masks = all(np.array_equal(got[k], want[k]) for k in ("surf_mask", "edge_mask"))
            err = max(float(np.abs(got[k] - want[k]).max()) for k in want
                      if want[k].dtype != bool)
            if not masks or err > tol or buckets != [bucket, bucket]:
                raise AssertionError(f"dp (c) {name}: masks equal {masks}, max abs diff "
                                     f"{err:.3e} (bar {tol:g}), buckets {buckets} / {bucket}")
            res[f"c_{name}"] = dict(max_abs_diff=err, buckets=buckets, k1_per_rank=k1)
            log(f"dp (c) {name}: B={batch_size} split over 2 gloo ranks on one card against "
                f"one process: masks equal, max abs diff {err:.3e} (bar {tol:g}); face bucket "
                f"{buckets[0]} on both ranks (one process: {bucket}); K1 {k1} a rank")
        torch.cuda.empty_cache()
        dist.barrier()

    # (d) the edgez denoiser at production width split over 2 ranks on the
    # mesh's model axis: 6 heads a rank through K1, against the replicated forward
    mesh = make_mesh((1, 2), device_type="cuda")
    model = replicate(seed_weights(build_denoiser("edgez"), torch.Generator().manual_seed(4))
                      .to("cuda").eval(), mesh)
    probe = edgez_probe(torch, model, 8)
    with torch.no_grad():
        want = model(*probe)
        shard_denoiser(model, mesh)
        reset_launch_counts()
        got = model(*probe)
        torch.cuda.synchronize()
    k1 = LAUNCH_COUNTS["packed_attention"]
    err = (got - want).abs()
    ok = bool((err <= TP_ATOL + TP_RTOL * want.abs()).all())
    heads = model.encoder.layer_0.attn.num_heads
    if not ok or k1 != 12 or heads != 6:
        raise AssertionError(f"dp (d): rank {rank}: max abs diff {err.max().item():.3e} (rtol "
                             f"{TP_RTOL:g} atol {TP_ATOL:g}), K1 {k1}, heads {heads}")
    if main_rank:
        res["d"] = dict(max_abs_diff=err.max().item(), k1_per_rank=k1, heads=heads)
        log(f"dp (d): edgez denoiser (12 layers, W=768) tensor-parallel over 2 gloo ranks, "
            f"{heads} heads a rank through K1 ({k1} launches a rank), B=2 S=600 f32: max abs "
            f"diff {err.max().item():.3e} to the replicated forward (rtol {TP_RTOL:g}, atol "
            f"{TP_ATOL:g})")
        with open(out, "w") as f:
            json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


GRAFT_RANKS = 4  # dryrun_multichip's ranks: a 2 x 2 data x model mesh


def phase_graft_entry(torch):
    """``brepgen_tpu_torch/graft_entry.py`` on the card: ``entry()``'s
    forward (the flagship edgez denoiser, head width 16, through K1) against
    the same forward on the CPU at 1e-4, then ``dryrun_multichip(4)``: gloo
    ranks sharing this card (NCCL where 4 cards are visible) take the edgez
    step on a 2 x 2 data x model mesh through K1/K5 at D = 16, held to the
    same step in one process with phase dp (b)'s bars (loss, clipped
    gradients, parameters), the replicated gradients equal on the model
    ranks, and the tiny cascade split 4 ways against the unsharded one at
    1e-4. Returns its paths for the kernels line."""
    from brepgen_tpu_torch import graft_entry
    from brepgen_tpu_torch.kernels import LAUNCH_COUNTS, reset_launch_counts

    fn, args = graft_entry.entry()
    with torch.no_grad():
        reset_launch_counts()
        got = fn(*args)
        torch.cuda.synchronize()
        k1 = LAUNCH_COUNTS["packed_attention"]
        cpu_fn, cpu_args = graft_entry.entry("cpu")
        want = cpu_fn(*cpu_args)
    err = (got.cpu() - want).abs().max().item()
    layers = graft_entry.FLAGSHIP["num_layers"]
    if not err <= 1e-4 or k1 != layers or fn.encoder.layer_0.attn.num_heads != 4:
        raise AssertionError(f"graft_entry: entry() on the card against the CPU max abs diff "
                             f"{err:.3e} (bar 1e-4), K1 {k1} launches for {layers} layers")
    log(f"graft_entry: entry() (edgez flagship, width 64, 4 heads: D=16, B=2, S=12) on the "
        f"card through K1 ({k1} launches) against the CPU: max abs diff {err:.3e} (bar 1e-4), "
        f"output {tuple(got.shape)}")
    del fn, got
    t = time.perf_counter()
    rep = graft_entry.dryrun_multichip(GRAFT_RANKS)
    seconds = time.perf_counter() - t
    train, sampling = rep["train"], rep["sampling"]
    launches = train["launches"]
    loss_rel = {k: abs(train["metrics"][k] - v) / abs(v) for k, v in train["ref_metrics"].items()}
    bad = [r for r, c in enumerate(launches) if not (c["packed_attention"] and
                                                      c["packed_attention_backward"])]
    if (train["mesh"] != [["data", 2], ["model", 2]] or bad
            or max(loss_rel.values()) > DP_LOSS_RTOL or train["grad_rel"] > GRAD_REL
            or train["param_max_abs_diff"] > DP_PARAM_ATOL
            or train["param_max_abs_diff_unresolved"] > 2 * DP_LR
            or train["replicated_grad_max_diff"] != 0.0
            or not all(sampling["k1_per_rank"])):
        raise AssertionError(f"graft_entry: dryrun_multichip({GRAFT_RANKS}): mesh "
                             f"{train['mesh']}, launches {launches} (none at ranks {bad}), "
                             f"loss relative {loss_rel} (bar {DP_LOSS_RTOL:g}), gradients' "
                             f"global relative difference {train['grad_rel']:.3e} (bar "
                             f"{GRAD_REL:g}), parameters {train['param_max_abs_diff']:.3e} / "
                             f"{train['param_max_abs_diff_unresolved']:.3e}, replicated "
                             f"gradients {train['replicated_grad_max_diff']:.3e}, sampling K1 "
                             f"{sampling['k1_per_rank']}")
    log(f"graft_entry: dryrun_multichip({GRAFT_RANKS}) over {rep['backend']} ranks sharing "
        f"this card in {seconds:.2f} s: train mesh (data 2, model 2), B={train['B']}, edgez "
        f"f32 step at D=16 (2 of 4 heads a rank): loss {train['metrics']['loss']:.7f} against "
        f"{train['ref_metrics']['loss']:.7f} in one process (relative "
        f"{max(loss_rel.values()):.2e}, bar {DP_LOSS_RTOL:g}), clip norm {train['norm']:.6f} / "
        f"{train['ref_norm']:.6f}, gradients gathered over model max abs diff "
        f"{train['grad_max_abs_diff']:.3e} (global relative {train['grad_rel']:.3e}, bar "
        f"{GRAD_REL:g}), parameters {train['param_max_abs_diff']:.3e} where the gradient is "
        f"resolved (bar {DP_PARAM_ATOL:g}), {train['param_max_abs_diff_unresolved']:.3e} at the "
        f"{train['unresolved_elements']} others (bar {2 * DP_LR:g}), replicated gradients "
        f"equal on the model ranks; K1/K5 launches by rank "
        + ", ".join(f"{c['packed_attention']}/{c['packed_attention_backward']}" for c in launches)
        + f"; sampling: tiny cascade (D=16) split 4 ways, max abs diff "
        f"{sampling['max_abs_diff']:.3e} to the unsharded one (bar 1e-4), K1 by rank "
        f"{sampling['k1_per_rank']}")
    return dict(
        entry=dict(path="graft_entry entry() (edgez flagship, W=64 H=4, D=16, B=2, S=12)",
                   launches=k1, max_abs_diff=err),
        train=dict(path="graft_entry dryrun_multichip(4) train (edgez f32 step, 2 x 2 data x "
                        "model mesh, D=16; per rank)", launches=launches,
                   seconds=seconds, **{k: v for k, v in train.items()
                                       if k not in ("launches", "grad_diff", "param_diff")}),
        sampling=dict(path="graft_entry dryrun_multichip(4) sampling (tiny cascade, D=16, split "
                           "4 ways; per rank)", launches=sampling["k1_per_rank"],
                      max_abs_diff=sampling["max_abs_diff"]))


BENCH_TRAIN_STEPS = 3   # the train-step bench: timed steps of each leg
BENCH_IO_STEPS = 5      # io_bench cached_only: timed device steps
BENCH_BUDGET_S = 90     # phase bench's share of the smoke's clock


def phase_bench(torch, work):
    """The measuring entry points on the card, each with the launch counts
    set to 0 just before it and read just after: ``brepgen_tpu_torch.bench``
    (30 replays of each captured step, then a measured deepcad PNDM + DDPM
    batch; K1 once a layer of every edge step and edge call),
    ``tools/bench_cascade.py deepcad kernel <cache> time:edgez@24 1`` (K1 in
    each of the 209 edgez calls, the graphs' manifest written), the
    train-step bench's plain and kernel legs (K1 forward and K5 backward in
    each layer of each kernel step, none in the plain leg), the Chamfer
    protocol bench (three K4 launches) and ``io_bench cached_only`` (the
    edgez step with remat: two K1 and one K5 a layer). Each entry's JSON line
    is printed by the entry. Returns the phase's paths for the kernels
    line."""
    from brepgen_tpu_torch import bench
    from brepgen_tpu_torch.diffusion import make_pndm_plan
    from brepgen_tpu_torch.kernels import LAUNCH_COUNTS, reset_launch_counts
    from brepgen_tpu_torch.sampling.aot import MANIFEST
    from brepgen_tpu_torch.tools import bench_cascade, chamfer_protocol_bench, io_bench, \
        train_step_bench

    t_phase = time.perf_counter()
    layers = 12
    edgez_calls = len(make_pndm_plan(200).t_model)

    def run(label, main, argv, want):
        reset_launch_counts()
        t = time.perf_counter()
        report = main(argv)
        seconds = time.perf_counter() - t
        launches = {k: n for k, n in LAUNCH_COUNTS.items() if n}
        if launches != want:
            raise AssertionError(f"bench {label}: launches {launches}, expected {want}")
        log(f"phase bench: {label} in {seconds:.2f} s, launches {launches}")
        return report, launches, seconds

    per_shape = bench.WARMUP + 30
    report, launches, seconds = run(
        "brepgen_tpu_torch.bench", bench.main, [],
        {"packed_attention": layers * (3 * per_shape + 2 * bench.EDGE_EVALS)})
    detail = report["detail"]
    if not (all(v == layers for v in detail["k1_launches_per_edge_step"].values())
            and math.isfinite(report["value"])
            and math.isfinite(detail["measured_cascade_s_per_batch16"])):
        raise AssertionError(f"bench: {report}")
    log(f"phase bench: {report['value']:.3f} B-reps/min estimated ({detail['edge_step_ms']:.3f} "
        f"ms an edge step, {detail['surf_step_ms']:.3f} a surf step, MFU "
        f"{detail['edge_mfu_vs_peak']:.4f} / {detail['surf_mfu_vs_peak']:.4f} of "
        f"{detail['mfu_peak_tflops']:g} TFLOP/s); cascade {detail['cascade_s_per_batch16']:.3f} "
        f"s a batch of 16 estimated, {detail['measured_cascade_s_per_batch16']:.3f} measured")
    paths = {"packed_attention": [dict(
        path="bench (brepgen_tpu_torch.bench: captured steps B16 at S 1800, 960, 1920, bf16, "
             f"{per_shape} replays each, then a measured deepcad PNDM + DDPM batch of 16)",
        launches=launches["packed_attention"], seconds=seconds, **detail)]}

    cache = os.path.join(work, "bench_graphs")
    report, launches, seconds = run(
        "bench_cascade time:edgez@24", bench_cascade.main,
        ["deepcad", "kernel", cache, "time:edgez@24", "1"],
        {"packed_attention": layers * edgez_calls})
    if not os.path.isfile(os.path.join(cache, MANIFEST)):
        raise AssertionError(f"bench_cascade: no {MANIFEST} in {cache}")
    paths["packed_attention"].append(dict(
        path="bench_cascade (deepcad, kernel, time:edgez@24, 1 rep, B=16, bf16)",
        launches=launches["packed_attention"], seconds=seconds, **report))

    steps = 1 + BENCH_TRAIN_STEPS  # a warm-up step and the timed ones, kernel leg only
    report, launches, seconds = run(
        "train_step_bench", train_step_bench.main, ["--steps", str(BENCH_TRAIN_STEPS)],
        {"packed_attention": layers * steps, "packed_attention_backward": layers * steps})
    train_path = dict(path=f"train_step_bench (edgez B=128 S=600 bf16, no remat, "
                           f"{BENCH_TRAIN_STEPS} steps a leg, plain then kernel)",
                      seconds=seconds, **report)
    paths["packed_attention"].append(dict(train_path, launches=launches["packed_attention"]))
    paths["packed_attention_backward"] = [dict(
        train_path, launches=launches["packed_attention_backward"])]

    out = os.path.join(work, "chamfer_protocol.json")
    report, launches, seconds = run("chamfer_protocol_bench", chamfer_protocol_bench.main,
                                    [out], {"chamfer": 3})
    paths["chamfer"] = [dict(path="chamfer_protocol_bench (3000 x 1000 clouds of 2000 points: "
                                  "a 256-row warm-up, the first call, a repeat)",
                             launches=launches["chamfer"], seconds=seconds, **report)]

    steps = 1 + BENCH_IO_STEPS
    report, launches, seconds = run(
        "io_bench cached_only", io_bench.main, ["cached_only", "--steps", str(BENCH_IO_STEPS)],
        {"packed_attention": 2 * layers * steps, "packed_attention_backward": layers * steps})
    io_path = dict(path=f"io_bench cached_only (edgez B=128 S=600 bf16, remat, cached "
                        f"latents, {BENCH_IO_STEPS} steps)", seconds=seconds, **report)
    paths["packed_attention"].append(dict(io_path, launches=launches["packed_attention"]))
    paths["packed_attention_backward"].append(dict(
        io_path, launches=launches["packed_attention_backward"]))

    seconds = time.perf_counter() - t_phase
    log(f"phase bench: the five entries in {seconds:.2f} s (budget {BENCH_BUDGET_S} s"
        + ("" if seconds <= BENCH_BUDGET_S else ", OVER") + ")")
    return paths


def chamfer_bound(S, R, P, n):
    """S*R*n^2 distances x 8 FLOP (3 sub, 3 mul, 2 add) in f32 against each
    cloud read once and the matrix written once. Each point-pair distance
    is counted once: both directions' mins read the same distance, so the
    function needs it once (a kernel with a pass per direction evaluates it
    twice, and this bound once counted it twice)."""
    flops = 1.0 * S * R * n * n * 8  # issue floor: 8 instructions a pair (6 + 2 FMNMX)
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


def chamfer_build_line(_build):
    """K4's registers and spills (-Xptxas=-v) and its FADD / FMUL / FFMA /
    FMNMX counts in the compiled kernel (cuobjdump), as one text."""
    regs = ptxas_table(_build.BUILD_LOG.get("chamfer", (0.0, ""))[1])
    sass = _build.sass_counts("chamfer", ("FADD", "FMUL", "FFMA", "FMNMX")) or {}
    parts = []
    for func, (r, st, ld) in regs.items():
        n = sass.get(func)
        text = f"{kernel_label(func)}: {r} registers, spills {st} B stored / {ld} B loaded"
        if n:
            arith = n["FADD"] + n["FMUL"] + n["FFMA"]
            text += (", SASS " + ", ".join(f"{v} {k}" for k, v in n.items())
                     + f" ({arith / max(n['FMNMX'], 1):.2f} FADD+FMUL+FFMA per FMNMX)")
        parts.append(text)
    return "; ".join(parts) or "no ptxas report"


def hold_chamfer_on_clouds(torch, np, label, fake_dir, real_dir, limit=64):
    """K4 on the first ``limit`` normalize_pc'd clouds of each folder (as the
    protocol loads them) against its plain version on the card, at
    CHAMFER_REL / CHAMFER_ABS; these comparison launches are not the
    path's. Returns the max abs error."""
    from brepgen_tpu_torch.eval.pipeline import _load_clouds
    from brepgen_tpu_torch.kernels.chamfer import chamfer_matrix, chamfer_matrix_reference

    x = torch.from_numpy(_load_clouds(fake_dir)[:limit].astype(np.float32)).cuda()
    y = torch.from_numpy(_load_clouds(real_dir)[:limit].astype(np.float32)).cuda()
    got = chamfer_matrix(x, y)
    want = chamfer_matrix_reference(x, y)
    diff = (got - want).abs()
    err = diff.max().item()
    if (diff > CHAMFER_REL * want.abs() + CHAMFER_ABS).any() or not torch.isfinite(got).all():
        raise AssertionError(f"{label}: K4 on the real clouds ({x.shape[0]} x {y.shape[0]}) "
                             f"against its plain version: max_abs_err {err:.3e}, tolerance "
                             f"{CHAMFER_REL:g}*|plain| + {CHAMFER_ABS:g}")
    log(f"{label}: K4 on {x.shape[0]} x {y.shape[0]} real normalize_pc'd clouds against its "
        f"plain version on the card: max_abs_err {err:.3e} (smallest entry "
        f"{want.min().item():.3e}); tolerance {CHAMFER_REL:g}*|plain| + {CHAMFER_ABS:g}")
    return err


def phase_chamfer(torch, gen, _build):
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
            if not torch.equal(got, chamfer_matrix(x, y, n_pts=n)):
                raise AssertionError(f"chamfer S={S} R={R} P={P} n={n}: two launches on the "
                                     f"same inputs differ")
            times = (f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, cdist "
                     f"yardstick (several calls) {row['yardstick_ms']:.4f} ms, bound "
                     f"{row['bound_ms']:.4f} ms ({row['bound_by']}); two launches bit-equal; "
                     f"{chamfer_build_line(_build)}")
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


SMALL_ARCHS = {  # phase small: name -> (denoiser widths, VAE widths)
    "--small (width 32, 2 heads: head width 16)": (
        dict(width=32, num_heads=2, ffn_width=64, num_layers=1), ((8, 8, 8, 8), (8, 8, 8))),
    "width 64, 2 heads, 2 layers": (
        dict(width=64, num_heads=2, ffn_width=128, num_layers=2), ((8, 8, 8, 8), (8, 8, 8))),
}


def phase_small(torch):
    """Small cascades on the card through the kernel against the same
    cascades on the CPU through the plain version: the sample CLI's
    ``--small`` architecture (head width 16) and width 64 with 2 heads.
    Returns one path a cascade (K1 launches on the card)."""
    from brepgen_tpu_torch import nn as tnn
    from brepgen_tpu_torch.cli.build import build_denoiser, seed_weights
    from brepgen_tpu_torch.kernels import LAUNCH_COUNTS, reset_launch_counts
    from brepgen_tpu_torch.sampling import Cascade, CascadeConfig

    cfg = CascadeConfig(batch_size=2, num_surfaces=6, num_edges=5, pndm_steps=20,
                        pos_pndm_calls=16, ddpm_tail=10)
    # f32 on two devices: summation orders differ through 160 denoiser calls
    tol = 1e-3
    paths = []
    for name, (arch, (surf_ch, edge_ch)) in SMALL_ARCHS.items():
        outs = {}
        for device in ("cpu", "cuda"):
            gen = torch.Generator().manual_seed(0)
            nets = {s: seed_weights(build_denoiser(s, arch="demo", **arch), gen).to(device).eval()
                    for s in ("surfpos", "surfz", "edgepos", "edgez")}
            vaes = [seed_weights(m, gen).to(device).eval()
                    for m in (tnn.SurfVAE(surf_ch), tnn.EdgeVAE(edge_ch))]
            cascade = Cascade(nets, *vaes, cfg)
            reset_launch_counts()
            out = cascade(CpuNoise(torch, device))
            outs[device] = {k: v.cpu() for k, v in out.items()}
        k1 = LAUNCH_COUNTS["packed_attention"]
        calls = cascade.model_calls["edgepos"] + cascade.model_calls["edgez"]
        if k1 != calls * arch["num_layers"]:
            raise AssertionError(f"small cascade {name}: K1 {k1} launches for {calls} edge "
                                 f"calls of {arch['num_layers']} layers")
        for k, want in outs["cpu"].items():
            got = outs["cuda"][k]
            if want.dtype == torch.bool:
                if not torch.equal(got, want):
                    raise AssertionError(f"small cascade {name}: {k} differs between card and "
                                         f"CPU")
            else:
                err = (got - want).abs().max().item()
                if not err <= tol:
                    raise AssertionError(f"small cascade {name}: {k} max abs diff {err:.3e} > "
                                         f"{tol:g}")
        err = max((outs["cuda"][k] - v).abs().max().item() for k, v in outs["cpu"].items()
                  if v.dtype != torch.bool)
        D = arch["width"] // arch["num_heads"]
        log(f"small cascade {name} (B=2, ns=12, ne=5, PNDM 20): card through K1 at D={D} "
            f"({k1} launches) against CPU through the plain version: masks equal, max abs "
            f"diff {err:.3e} (tolerance {tol:g})")
        paths.append(dict(path=f"small cascade {name}, card against CPU", launches=k1,
                          head_width=D, max_abs_diff=err))
    return paths


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
    ends = []  # stage_times at the end of each batch

    def after_stage(stage):
        events.append((stage, LAUNCH_COUNTS[kernel]))
        if stage == "decode":
            ends.append(dict(stage_times))

    calls0 = sum(cascade.model_calls[s] for s in ("edgepos", "edgez"))
    with tempfile.TemporaryDirectory() as tmp:
        folder = save_folder or tmp
        reset_launch_counts()
        run = sample_loop(cascade, max_batches=batches, seed=0, save_folder=folder,
                          stage_times=stage_times, postprocess=save_folder is not None,
                          recovery=True, workers=4, after_stage=after_stage)
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
                attempted=run.attempted,
                batch_stage_seconds=[{k: v - prev.get(k, 0.0) for k, v in end.items()}
                                     for prev, end in zip([{}] + ends, ends)]), run


def phase_solids(torch, np, cascade, batch, folder):
    """Batch 0 of the protocol run through ``process_one`` with recovery, one
    sample after another (no overlap): STEP + STL into ``folder``; the STEP
    files of the solids among them in ``solid_steps``."""
    from brepgen_tpu_torch.cli.sample_main import SampleRun, host_decoders, process_one
    from brepgen_tpu_torch.kernels import LAUNCH_COUNTS, reset_launch_counts

    surf_decode, edge_decode = host_decoders(cascade)
    run = SampleRun(batches=[batch])
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    per_sample, solid_steps = [], []
    for b in range(cascade.cfg.batch_size):
        t = time.perf_counter()
        name, note = process_one(batch, b, surf_decode, edge_decode, cascade.cfg.z_threshold,
                                 folder, recovery=True, device=cascade.device)
        per_sample.append(time.perf_counter() - t)
        run.add(name, note)
        run.attempted += 1
        if name is not None and "nonsolid" not in (note or ""):
            solid_steps.append(os.path.join(folder, name + ".step"))
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
                solid=run.solid, failures=run.failures, rungs=run.rungs, seconds=run.seconds,
                solid_steps=solid_steps)


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
    real_err = hold_chamfer_on_clouds(torch, np, "eval", fake, real)
    log(f"eval: {n_fake} STLs sampled to 2000-point clouds in {t1 - t0:.2f} s; "
        f"against 64 random-box clouds (seed {seed}), {times} repeats in {t2 - t1:.2f} s, "
        f"chamfer launches {launches['chamfer']} (one per repeat); SMOKE values, not a "
        f"quality number: " + ", ".join(f"{k} {v:.6f}" for k, v in avg.items()))
    return dict(clouds=n_fake, launches=launches["chamfer"], seconds=t2 - t1, metrics=avg,
                max_abs_err_real_clouds=real_err)


def phase_abc_compact(torch, np):
    """Mode abc on the all160k packs, batch 4, f32, DDIM, without (two
    batches) and with (one) face-token compaction: the same noise, so the
    kept faces' outputs agree; each captured run held to its eager twin."""
    from brepgen_tpu_torch.cli.sample_main import init_cascade

    runs = {}
    for compact in (False, True):
        cascade = init_cascade("abc", PACKS, batch_size=4, device="cuda",
                               step_overrides={"fast_steps": ABC_STEPS, "compact": compact})
        label = (f"abc {'compact' if compact else 'full'} (all160k packs, B=4, f32, DDIM "
                 f"{ABC_STEPS})")
        path, run = drive(torch, np, label, cascade, 2 * ABC_STEPS, batches=1 + (not compact))
        path["graphs_vs_eager"] = graphs_leg(torch, np, label, cascade, (path, run),
                                             2 * ABC_STEPS)
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
    edge_s = {c: p["batch_stage_seconds"][0]["edgepos"] + p["batch_stage_seconds"][0]["edgez"]
              for c, p in ((False, full_path), (True, comp_path))}  # batch 0 of each
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
    label = f"long set (--config 70 x 60, production width, seeded, f32, DDIM {LONG_STEPS})"
    path, run = drive(torch, np, label, cascade, 2 * LONG_STEPS, kernel="packed_flash_attention")
    path["graphs_vs_eager"] = graphs_leg(torch, np, label, cascade, (path, run),
                                         2 * LONG_STEPS, kernel="packed_flash_attention")
    return path


def compare_batches(np, label, want, got):
    """Max abs difference of every output over the batches of two runs;
    masks must be equal and values within GRAPH_REL of each output's largest
    magnitude. Returns {output: max abs difference}."""
    errs = {}
    for b, (w, g) in enumerate(zip(want, got)):
        for k, v in w.items():
            if v.dtype == bool:
                if not np.array_equal(v, g[k]):
                    raise AssertionError(f"{label}: batch {b} {k} differs")
                continue
            err = float(np.abs(g[k].astype(np.float64) - v).max())
            errs[k] = max(errs.get(k, 0.0), err)
            if err > GRAPH_REL * float(np.abs(v).max()):
                raise AssertionError(f"{label}: batch {b} {k} max abs diff {err:.3e} > "
                                     f"{GRAPH_REL:g} x {float(np.abs(v).max()):.3e}")
    return errs


def graphs_leg(torch, np, label, cascade, captured, expected_edge_calls,
               kernel="packed_attention"):
    """The captured drive ``captured`` ((path, run) of ``drive`` on
    ``cascade``, whose stages replay CUDA graphs as on every card run)
    against the same cascade run eagerly (the same models and config, no
    graphs) on the same noise, batch by batch: outputs, ``kernel`` launches
    per batch and seconds per stage at each batch index."""
    from brepgen_tpu_torch.sampling import Cascade

    c_path, c_run = captured
    twin = Cascade(cascade.nets, cascade.surf_vae, cascade.edge_vae, cascade.cfg)
    e_path, e_run = drive(torch, np, f"{label}, eager", twin, expected_edge_calls,
                          batches=c_path["batches"], kernel=kernel)
    del twin
    errs = compare_batches(np, label, e_run.batches, c_run.batches)
    per_batch = {m: p["launches"] // p["batches"] for m, p in (("eager", e_path),
                                                                ("captured", c_path))}
    if per_batch["captured"] != per_batch["eager"]:
        raise AssertionError(f"{label}: {kernel} launches per batch {per_batch}")
    entries = cascade.graphs.entries
    fmt = lambda d: ", ".join(f"{k} {v:.3f}" for k, v in d.items())  # noqa: E731
    log(f"graphs {label}: captured against eager on the same noise, {len(c_run.batches)} "
        f"batch(es): max abs diff {max(errs.values()):.3e} (bar {GRAPH_REL:g} of each "
        f"output's largest; by output {errs}); {kernel} launches per batch "
        f"{per_batch['captured']} both ways, held to the graphs' kernel nodes; "
        f"{len(entries)} graphs ("
        + ", ".join(f"{e['stage']} x{e['shapes']['x']}: {e['kernel_nodes']} kernel nodes, "
                    f"launches {e['launches']}, {e['capture_seconds']:.2f} s" for e in entries)
        + "); seconds per stage, "
        + "; ".join(f"batch {b}{' (with the captures)' if b == 0 else ''}: eager {fmt(e)}, "
                    f"captured {fmt(c)}" for b, (e, c) in
                    enumerate(zip(e_path["batch_stage_seconds"], c_path["batch_stage_seconds"]))))
    return dict(label=label, max_abs_diff=errs, launches_per_batch=per_batch["captured"],
                graphs=len(entries), eager_stage_seconds=e_path["batch_stage_seconds"],
                captured_stage_seconds=c_path["batch_stage_seconds"])


def quiet(fn, *args):
    """``fn(*args)`` with its standard output kept (returned beside the
    result): the smoke's own output keeps one JSON line of kernels."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(*args)
    return result, buf.getvalue()


def phase_rescore(torch, np, work):
    """all160k at the size its packs were trained at (10 x 8 face and edge
    slots, B=16, the PNDM + DDPM protocol, bf16, stages captured) through
    ``resample_main --recover --dump``, a strict ``--from_dump`` replay of
    the same dump, and both scored by ``metrics_main`` against 64 held-out
    clouds (seed 777, family all) through K4. Batch 0 again eagerly, held to
    the captured one. Fails below RESCORE_MIN validity."""
    from brepgen_tpu_torch.cli import metrics_main, resample_main
    from brepgen_tpu_torch.cli.sample_main import load_models
    from brepgen_tpu_torch.diffusion import make_pndm_plan
    from brepgen_tpu_torch.kernels import LAUNCH_COUNTS, reset_launch_counts
    from brepgen_tpu_torch.sampling import Cascade, CascadeConfig

    rec, strict = os.path.join(work, "recovered"), os.path.join(work, "strict")
    common = ["--weights_dir", PACKS, "--z_thresholds", "0.2", "--bf16"]
    t0 = time.perf_counter()
    reset_launch_counts()
    (line_rec,), out = quiet(resample_main.main, common + [
        "--out", rec, "--sample_batches", str(RESCORE_BATCHES), "--recover", "--dump",
        "--aot_cache", os.path.join(work, "graphs")])
    launches = dict(LAUNCH_COUNTS)
    t1 = time.perf_counter()
    cfg = CascadeConfig()
    edge_calls = cfg.pos_pndm_calls + cfg.ddpm_tail + len(make_pndm_plan(cfg.pndm_steps).t_model)
    want = 6 * edge_calls * RESCORE_BATCHES  # the packs' 6 layers in every edge-stage call
    if launches["packed_attention"] != want or sum(launches.values()) != want:
        raise AssertionError(f"rescore: launches {launches}, expected {want} packed_attention "
                             f"and nothing else")
    sampled = next(ln for ln in out.splitlines() if ln.startswith("sampled"))
    with open(os.path.join(work, "graphs", "graphs.json")) as f:
        manifest = json.load(f)
    (line_strict,), _ = quiet(resample_main.main, common + [
        "--out", strict, "--from_dump", os.path.join(rec, "batches.npz")])
    t2 = time.perf_counter()
    if line_strict["valid_breps"] != line_rec["valid_strict"]:
        raise AssertionError(f"rescore: the strict replay made {line_strict['valid_breps']} "
                             f"solids, the recovered run {line_rec['valid_strict']} strict ones")

    # the captured batch 0 against the same batch eagerly
    dumped = resample_main.load_dump(os.path.join(rec, "batches.npz"))[0]
    models = load_models(False, PACKS, dtype=torch.bfloat16)
    eager_cfg = CascadeConfig(batch_size=resample_main.BATCH, num_surfaces=10, num_edges=8)
    (eager,), _ = quiet(resample_main.generate, Cascade(*models, eager_cfg), 1,
                        resample_main.SEED)
    errs = compare_batches(np, "rescore batch 0, bf16", [eager], [dumped])
    del models
    t3 = time.perf_counter()

    reset_launch_counts()
    scores = {}
    for name, line in (("recovered", line_rec), ("strict", line_strict)):
        scores[name], _ = quiet(metrics_main.main, [
            "--run", work, "--samples_dir", os.path.join(work, name, "z0.2"), "--heldout", "64"])
        if scores[name]["n_fake_clouds"] != line["valid_breps"]:
            raise AssertionError(f"rescore: {scores[name]['n_fake_clouds']} clouds of "
                                 f"{line['valid_breps']} {name} solids")
    if LAUNCH_COUNTS["chamfer"] != 6 or LAUNCH_COUNTS["packed_attention"]:
        raise AssertionError(f"rescore metrics: launches {dict(LAUNCH_COUNTS)}, expected 6 "
                             f"chamfer (3 repeats x 2 sets)")
    t4 = time.perf_counter()
    real_errs = {name: hold_chamfer_on_clouds(
        torch, np, f"rescore metrics ({name})",
        os.path.join(work, name, "z0.2") + "_fake_ply", os.path.join(work, "heldout_ply"))
        for name in scores}
    n = line_rec["attempted"]
    if line_rec["validity"] < RESCORE_MIN["recovered"] or \
            line_strict["validity"] < RESCORE_MIN["strict"]:
        raise AssertionError(f"rescore: validity {line_rec['validity']} recovered, "
                             f"{line_strict['validity']} strict, below {RESCORE_MIN}")
    fmt = lambda m: (f"MMD-CD {m['avg-MMD-CD']:.4f}, COV-CD {m['avg-COV-CD']:.3f}, "  # noqa: E731
                     f"JSD {m['avg-JSD']:.3f}")
    log(f"rescore (all160k packs, 10 x 8, B=16, bf16, PNDM + DDPM, captured): {sampled}; "
        f"{len(manifest)} graphs, captured in "
        f"{sum(e['capture_seconds'] for e in manifest):.2f} s; K1 launches {want} = 6 layers x "
        f"{edge_calls} edge-stage calls x {RESCORE_BATCHES} batches; batch 0 eager against "
        f"captured: max abs diff {max(errs.values()):.3e}")
    log(f"rescore n={n}: recovered {line_rec['valid_breps']}/{n}, strict "
        f"{line_strict['valid_breps']}/{n}, solid {line_rec['valid_solid']}/{n}, rungs "
        f"{line_rec['recovered']}, strict failures {line_strict['failures']}; recovered "
        f"{fmt(scores['recovered'])}; strict {fmt(scores['strict'])}; BASELINE.md's n=64 row "
        f"(round 4 packs): strict 45/64 = 70.3%, recovered 64/64, rungs 4/5/6 = 3/5/11, "
        f"MMD-CD 0.0220 / 0.0219, COV-CD 0.531 / 0.422, JSD 0.187 / 0.189 (recovered / "
        f"strict); seconds: sample + postprocess {t1 - t0:.2f} (postprocess "
        f"{line_rec['postprocess_s']}), strict replay {t2 - t1:.2f}, eager batch {t3 - t2:.2f}, "
        f"metrics {t4 - t3:.2f}")
    keep = ("attempted", "valid_breps", "valid_strict", "valid_solid", "recovered",
            "failures", "postprocess_s")
    return dict(path="rescore (resample_main, all160k, 10 x 8, B=16, bf16, captured)",
                launches=want, recovered={k: line_rec[k] for k in keep},
                strict={k: line_strict[k] for k in keep}, metrics=scores,
                graphs=len(manifest), max_abs_diff_eager=errs, chamfer_launches=6,
                chamfer_max_abs_err_real_clouds=real_errs, seconds=t4 - t0)


KERNEL_NAMES = ("set_attention_kernel", "set_attention_wgmma_kernel", "packed_attention_kernel",
                "packed_attention_wgmma_kernel", "dkv_kernel", "dq_kernel", "dkv_wgmma_kernel",
                "dq_wgmma_kernel", "chamfer_kernel")
# (source, function label) -> (registers, spill stores, spill loads), from
# build_report, for the kernel phases' lines
REGISTERS = {}


def registers_text(source, *labels):
    """"dq_wgmma_kernel<bf16, D=64> 168 registers, 0/0 B spilled; ..." of
    the given functions of ``source``."""
    parts = []
    for label in labels:
        regs, st, ld = REGISTERS.get((source, label), (None, None, None))
        parts.append(f"{label} {regs} registers, {st}/{ld} B spilled" if regs is not None
                     else f"{label} registers not reported")
    return "; ".join(parts)


def kernel_label(mangled):
    """``set_attention_kernel<bf16, D=64>`` from a mangled kernel name."""
    m = re.search(r"(" + "|".join(KERNEL_NAMES) + r")(?:I(13__nv_bfloat16|f)Li(\d+)E)?",
                  mangled)
    if not m:
        return mangled
    if not m.group(2):
        return m.group(1)
    return f"{m.group(1)}<{'bf16' if 'bfloat16' in m.group(2) else 'f32'}, D={m.group(3)}>"


def ptxas_table(report):
    """{mangled name: (registers, spill stores, spill loads)} from -Xptxas=-v."""
    table, func = {}, None
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            func = m.group(1)
            table[func] = [0, 0, 0]
        elif func and "bytes spill stores" in ln:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
            table[func][1:] = [int(m.group(1)), int(m.group(2))]
        elif func and "Used" in ln and "registers" in ln:
            table[func][0] = int(re.search(r"Used (\d+) registers", ln).group(1))
    return table


def dynamic_smem(name, lib, label):
    """Bytes of dynamic shared memory per block of the K1/K2, K3 and K5
    kernels, from their launchers' own sizes."""
    m = re.search(r"<(\w+), D=(\d+)>", label)
    if not m:
        return None
    D, dtype = int(m.group(2)), int(m.group(1) == "bf16")
    if name == "set_attention":
        return lib.set_attention_smem_bytes(D, dtype)
    if name == "packed_attention":
        return lib.packed_attention_smem_bytes(D, dtype)
    if name == "packed_attention_bwd":
        return lib.packed_attention_backward_smem_bytes(D, dtype, int(label.startswith("dkv")))
    return None


def build_report(_build, kernels):
    """One line per kernel function of each source: registers, spills,
    shared memory and its HMMA, HGMMA and UTMALDG instructions (from
    cuobjdump). A function of a tensor-core source with no HMMA or HGMMA
    raises, and so does a bf16 function of packed_attention.cu (K1/K2),
    packed_attention_bwd.cu (K5) or set_attention.cu (K3) without HGMMA
    and UTMALDG. Returns {source: {function label: counts}} of the
    tensor-core sources."""
    counts = {}
    for name in kernels:
        secs, report = _build.BUILD_LOG.get(name, (0.0, ""))
        sass = _build.sass_counts(name)
        if sass is None:
            log(f"  nvcc {name}: {secs:.2f} s; cuobjdump not in the toolkit: tensor-core "
                f"instructions not counted")
        else:
            log(f"  nvcc {name}: {secs:.2f} s")
        lib = _build.load(name)
        for func, (regs, st, ld) in ptxas_table(report).items():
            label = kernel_label(func)
            REGISTERS[(name, label)] = (regs, st, ld)
            smem = dynamic_smem(name, lib, label)
            n = None if sass is None else sass.get(func, dict.fromkeys(_build.SASS_OPCODES, 0))
            log(f"  {label} ({name}.cu): {regs} registers, spills {st} B stored / {ld} B "
                f"loaded, " + (f"{smem} B dynamic shared memory" if smem is not None
                               else "shared memory as in its source")
                + ("" if n is None else ", " + ", ".join(f"{v} {k}" for k, v in n.items())))
        if name in TENSOR_CORE_SOURCES and sass is not None:
            labels = {kernel_label(func): n for func, n in sass.items()}
            if not labels or not all(n["HMMA"] + n["HGMMA"] for n in labels.values()):
                raise AssertionError(f"{name}.cu: a kernel runs no tensor-core instruction "
                                     f"({labels})")
            bf16 = {k: n for k, n in labels.items() if "bf16" in k}
            if not bf16 or not all(
                    n["HGMMA"] and n["UTMALDG"] for n in bf16.values()):
                raise AssertionError(f"{name}.cu: a bf16 kernel runs no wgmma or no TMA "
                                     f"({labels})")
            counts[name] = labels
    return counts


def kernel_entry(name, source, replaces, launches, shapes, paths, **extra):
    """A line of the kernels JSON: the numbers of the first (main) shape."""
    main_shape = shapes[0]
    return dict(name=name, route="cuda", source=source, replaces=replaces, launches=launches,
                max_abs_err=max(r["max_abs_err"] for r in shapes if "max_abs_err" in r),
                ms=main_shape["ms"], plain_ms=main_shape["plain_ms"],
                bound_ms=main_shape["bound_ms"], bound_by=main_shape["bound_by"],
                bound_ms_f32_simt=main_shape.get("bound_ms_f32_simt"),
                library_ms=main_shape.get("library_ms"), **extra, shapes=shapes, paths=paths)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the reference clouds of the eval phase and its cloud draws")
    # phase dp starts two ranks of this script: --dp_worker RANK
    p.add_argument("--dp_worker", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--dp_init", default=None, help=argparse.SUPPRESS)
    p.add_argument("--dp_out", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if args.dp_worker is not None:
        return dp_worker(torch, np, args.dp_worker, args.dp_init, args.dp_out)
    # full f32 in matrix products and convolutions, as the CPU reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from concurrent.futures import ThreadPoolExecutor

    from brepgen_tpu_torch import nvidia_smi_card
    from brepgen_tpu_torch.cli.sample_main import init_cascade
    from brepgen_tpu_torch.diffusion import make_pndm_plan
    from brepgen_tpu_torch.geometry import native_bindings
    from brepgen_tpu_torch.kernels import _build

    smi = nvidia_smi_card(0)
    print(smi, flush=True)
    t = time.perf_counter()
    kernels = ("packed_attention", "set_attention", "chamfer", "packed_attention_bwd")
    # one nvcc per source and g++ for the native host library, all together
    with ThreadPoolExecutor(len(kernels) + 1) as pool:
        host_lib = pool.submit(native_bindings.load)
        list(pool.map(_build.load, kernels))
        host_lib = host_lib.result()
    build_s = time.perf_counter() - t
    log(f"env: python {sys.version.split()[0]}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, card {torch.cuda.get_device_name(0)} ({smi}), "
        f"{torch.cuda.device_count()} visible; {', '.join(kernels)} and the native host "
        f"library ({os.path.relpath(host_lib._name, ROOT)}) built in {build_s:.2f} s")
    tensor_cores = build_report(_build, kernels)

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
    chamfer_shapes = phase_chamfer(torch, torch.Generator(device="cuda").manual_seed(args.seed),
                                   _build)
    log(f"phase kernel chamfer done in {time.perf_counter() - t:.2f} s")

    t = time.perf_counter()
    small_paths = phase_small(torch)
    log(f"phase small done in {time.perf_counter() - t:.2f} s")

    paths = {k: [] for k in ATTENTION_KERNELS}
    t = time.perf_counter()
    cascade = init_cascade("deepcad", seed=0, batch_size=16, device="cuda",
                           step_overrides={"fast_steps": DEEPCAD_STEPS})
    log(f"cascade: production weights seeded in {time.perf_counter() - t:.2f} s")
    label = f"cascade deepcad (production width, seeded, f32, DDIM {DEEPCAD_STEPS})"
    path, run = drive(torch, np, label, cascade, 2 * DEEPCAD_STEPS, batches=2)
    path["graphs_vs_eager"] = graphs_leg(torch, np, label, cascade, (path, run),
                                         2 * DEEPCAD_STEPS)
    paths["packed_attention"].append(path)
    del cascade, run
    torch.cuda.empty_cache()
    log(f"phase cascade done in {time.perf_counter() - t:.2f} s")

    t = time.perf_counter()
    cascade = init_cascade("abc", seed=0, batch_size=16, device="cuda",
                           step_overrides={"fast_steps": ABC_STEPS})
    log(f"abc: production weights seeded in {time.perf_counter() - t:.2f} s")
    label = f"abc (production width, seeded, f32, DDIM {ABC_STEPS})"
    path, run = drive(torch, np, label, cascade, 2 * ABC_STEPS, kernel="set_attention")
    path["graphs_vs_eager"] = graphs_leg(torch, np, label, cascade, (path, run), 2 * ABC_STEPS,
                                         kernel="set_attention")
    paths["set_attention"].append(path)
    del cascade, run
    torch.cuda.empty_cache()
    log(f"phase abc done in {time.perf_counter() - t:.2f} s")

    t = time.perf_counter()
    paths["packed_attention"] += phase_abc_compact(torch, np)
    torch.cuda.empty_cache()
    log(f"phase abc compact done in {time.perf_counter() - t:.2f} s")

    # phase step reads the STEP files of phases solids and overlap (in
    # ``work``) and the solids and VAE packs of phase pipeline (in
    # ``pipeline_work``, under build/)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory() as work, \
            tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as pipeline_work:
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
        solid_steps = solids.pop("solid_steps")
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
        os.makedirs(os.path.join(work, "rescore"))
        rescore = phase_rescore(torch, np, os.path.join(work, "rescore"))
        paths["packed_attention"].append(rescore)
        torch.cuda.empty_cache()
        log(f"phase rescore done in {time.perf_counter() - t:.2f} s")

        t = time.perf_counter()
        training = phase_train(torch, np, os.path.join(work, "train"))
        log(f"phase train done in {time.perf_counter() - t:.2f} s")
        torch.cuda.empty_cache()

        t = time.perf_counter()
        pipeline = phase_pipeline(torch, np, pipeline_work)
        cached = pipeline["ldm"]["cached"]
        pipeline_path = dict(path="pipeline (ldm_main edgez --cache_latents --profile, "
                                  "production width, bf16, B=128, S=600, on process_main's "
                                  "solids and the VAEs just trained)", **cached)
        log(f"phase pipeline done in {time.perf_counter() - t:.2f} s")
        torch.cuda.empty_cache()

        t = time.perf_counter()
        step = phase_step(torch, np, os.path.join(work, "solids"), solid_steps,
                          os.path.join(pipeline_work, "step"), pipeline)
        step_path = dict(path=f"step (ldm_main edgez, production width, bf16, B=128, S=600, on "
                              f"{STEP_SOLIDS} solids written as STEP and extracted by "
                              f"shard_driver, the pipeline's VAEs)", **step["train"])
        log(f"phase step done in {time.perf_counter() - t:.2f} s: host seconds "
            f"{step['validated']['seconds_per_file']:.4f} per validated file, "
            f"{step['written']['seconds_per_solid']:.4f} per written solid, "
            f"{step['extracted']['seconds_per_solid']:.4f} per extracted solid; (a) "
            f"{step['validated']['seconds']:.2f} s, (b) {step['written']['seconds']:.2f} s, (c) "
            f"{step['extracted']['seconds']:.2f} s, (d) {step['train']['seconds']:.2f} s")
        torch.cuda.empty_cache()

        t = time.perf_counter()
        os.makedirs(os.path.join(work, "dp"))
        dp = phase_dp(torch, np, os.path.join(work, "dp"))
        log(f"phase dp done in {time.perf_counter() - t:.2f} s")
        dp_a = dict(path="dp (a) (torchrun --nproc_per_node 1 ldm_main --dp, NCCL, edgez, "
                         "production width, bf16, B=128, S=600)", **dp["a"])
        t = time.perf_counter()
        graft = phase_graft_entry(torch)
        torch.cuda.empty_cache()
        log(f"phase graft_entry done in {time.perf_counter() - t:.2f} s")

        t = time.perf_counter()
        bench_paths = phase_bench(torch, work)
        torch.cuda.empty_cache()
        log(f"phase bench done in {time.perf_counter() - t:.2f} s")
        dp_paths = [
            dict(path="dp (b) (split edgez step, f32, B=128 as 64 + 64 over 2 gloo ranks on "
                      "one card; per rank)", launches=dp["b"]["launches"]["packed_attention"],
                 **{k: v for k, v in dp["b"].items() if k != "launches"}),
            dict(path="dp (c) (split deepcad sampling, seeded production width, f32, B=16 as 8 "
                      "+ 8, DDIM 4; per rank)", launches=dp["c_deepcad"]["k1_per_rank"],
                 **dp["c_deepcad"]),
            dict(path="dp (c) (split abc compacted on the all160k packs, B=4 as 2 + 2; per "
                      "rank)", launches=dp["c_abc_compact"]["k1_per_rank"], **dp["c_abc_compact"]),
            dict(path="dp (d) (tensor-parallel edgez forward, 6 of 12 heads a rank, B=2, "
                      "S=600, f32; per rank)", launches=dp["d"]["k1_per_rank"], **dp["d"]),
            dict(path="dp (e) (convert_torch edgez pack, one forward, B=2, S=600)",
                 launches=dp["e"]["launches"], max_abs_diff=dp["e"]["max_abs_diff"]),
        ]

    # the top-level numbers are those of the main shape (the first of each
    # kernel's shapes: production width in f32; chamfer: the n=256 eval
    # protocol) and launches those of the kernel's first driven path; "shapes"
    # has every measured shape, "paths" every run
    csrc = "brepgen_tpu_torch/kernels/csrc/"
    print(json.dumps({"kernels": [
        kernel_entry("packed_attention", csrc + "packed_attention.cu",
                     "brepgen_tpu/kernels/attention.py:150",
                     paths["packed_attention"][0]["launches"], shapes["packed_attention"],
                     paths["packed_attention"] + [
                         dict(pipeline_path, launches=cached["k1_launches"]),
                         dict(step_path, launches=step["train"]["k1_launches"]),
                         dict(dp_a, launches=dp["a"]["launches"]["packed_attention"])]
                     + dp_paths + small_paths + [
                         graft["entry"], graft["sampling"],
                         dict(graft["train"], launches=[
                             c["packed_attention"] for c in graft["train"]["launches"]])]
                     + bench_paths["packed_attention"],
                     tensor_core_instructions=tensor_cores.get("packed_attention")),
        kernel_entry("packed_flash_attention", csrc + "packed_attention.cu",
                     "brepgen_tpu/kernels/attention.py:261",
                     paths["packed_flash_attention"][0]["launches"],
                     shapes["packed_flash_attention"], paths["packed_flash_attention"],
                     tensor_core_instructions=tensor_cores.get("packed_attention")),
        kernel_entry("set_attention", csrc + "set_attention.cu",
                     "brepgen_tpu/kernels/attention.py:47",
                     paths["set_attention"][0]["launches"], shapes["set_attention"],
                     paths["set_attention"],
                     tensor_core_instructions=tensor_cores.get("set_attention")),
        kernel_entry("chamfer", csrc + "chamfer.cu", "brepgen_tpu/kernels/chamfer.py:47",
                     evaluation["launches"], chamfer_shapes,
                     [dict(path="eval (STL -> clouds -> JSD/MMD/COV)", **evaluation),
                      dict(path="solids (protocol batch 0, serial)", **solids),
                      dict(path="rescore metrics (metrics_main, recovered and strict, "
                                "64 held-out clouds)", launches=rescore["chamfer_launches"],
                           metrics=rescore["metrics"])] + bench_paths["chamfer"],
                     yardstick_ms=chamfer_shapes[0]["yardstick_ms"]),
        kernel_entry("packed_attention_backward", csrc + "packed_attention_bwd.cu",
                     "brepgen_tpu/kernels/attention.py:377", training["launches"],
                     backward_shapes, [training, pipeline_path, step_path,
                                       dict(dp_a, launches=dp["a"]["launches"][
                                           "packed_attention_backward"]),
                                       dict(dp_paths[0], launches=dp["b"]["launches"][
                                           "packed_attention_backward"]),
                                       dict(graft["train"], launches=[
                                           c["packed_attention_backward"]
                                           for c in graft["train"]["launches"]])]
                     + bench_paths["packed_attention_backward"],
                     packed_attention_ms=backward_shapes[0]["packed_attention_ms"],
                     tensor_core_instructions=tensor_cores.get("packed_attention_bwd")),
    ]}), flush=True)
    log(f"all phases passed in {time.perf_counter() - T0:.2f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
