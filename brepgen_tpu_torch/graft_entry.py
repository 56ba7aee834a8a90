"""Entry check of the port: one forward of the flagship denoiser, and the
multi-process dry run of a data x model train step and of split sampling.

Counterpart of ``__graft_entry__.py``; run as

    python -m brepgen_tpu_torch.graft_entry [--device cpu]

``entry(device=None)`` returns ``(fn, args)``: ``fn`` is the edgez denoiser
at the flagship's size (width 64, 4 heads, FFN 128, 2 layers; seeded
weights) in eval mode, its attention on the kernel route, and ``args`` its
example inputs, the five streams ``[2, 12, 12/6/6/6/48]``, the timesteps and
a key-padding mask, as ``__graft_entry__.py:20-42`` shapes them (seeded,
non-zero, with padded slots, where JAX's are zeros). The head width is
16 = 64 / 4, the same as JAX's: on the card every layer runs K1
(``kernels/csrc/packed_attention.cu``) at D = 16, with no plain attention
and no other width. It runs on the card unless ``device="cpu"`` (there the
kernels' plain versions run).

``dryrun_multichip(n, device=None)`` runs the two legs of JAX's dry run over
n ranks of one ``torch.distributed`` group:
  * train: the full edgez step (``train.ldm_train.make_edgez_step``: frozen
    encodes, condition augmentation, noising, forward and backward through
    K1/K5 on the card, the ClippedAdamW update) on a ``("data", "model")``
    mesh of ``(n // model_par, model_par)``, ``model_par = 2`` when n is
    even and at least 4 (``__graft_entry__.py:123``): the denoiser split
    over ``model`` by ``parallel.sharding_rules.shard_denoiser`` (Megatron's
    f and g as autograd functions), the batch of ``2 n / model_par``
    synthetic solids split over ``data`` (DDP over the data axis alone).
    Rank 0 then takes the same step in one process and reports how far the
    split step lies from it: loss, clip norm, each gradient gathered over
    ``model``, the parameters after the update, and whether the replicated
    parameters' gradients are equal on the model ranks;
  * sampling: the tiny cascade (width 32, 2 heads: head width 16 through K1
    on the card) split over the n ranks on ``data`` only, held to the
    unsharded cascade at rtol = atol = 1e-4 (``__graft_entry__.py:278``).
Outside a process group it starts the n ranks as processes of this module
and fails if any fails: NCCL with one card a rank where ``n`` cards are
visible, else gloo with the ranks sharing the visible cards (rank r on
``cuda:(r % count)``), and gloo on the CPU only when ``device="cpu"`` is
asked. It returns rank 0's report (a dict). Imports torch, numpy and the
port only.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from brepgen_tpu_torch import resolve_device
from brepgen_tpu_torch.cli.build import seed_weights
from brepgen_tpu_torch.data.assembly import assemble_edgez
from brepgen_tpu_torch.data.synthetic import make_dataset
from brepgen_tpu_torch.diffusion.ddpm import make_ddpm_tables
from brepgen_tpu_torch.kernels import LAUNCH_COUNTS, reset_launch_counts
from brepgen_tpu_torch.nn import EdgeVAE, SurfVAE
from brepgen_tpu_torch.nn import denoiser as tden
from brepgen_tpu_torch.parallel import data_parallel, data_split, make_mesh, replicate, \
    shard_batch
from brepgen_tpu_torch.parallel.distributed import RowSplit, in_group, rank_and_world
from brepgen_tpu_torch.parallel.sharding_rules import all_gather, gather_model, \
    shard_denoiser
from brepgen_tpu_torch.sampling import Cascade, CascadeConfig, GeneratorNoise, RowNoise
from brepgen_tpu_torch.train.common import TrainState, make_ldm_optimizer
from brepgen_tpu_torch.train.ldm_train import make_edgez_step
from brepgen_tpu_torch.train.vae_train import make_encoder_fn

FLAGSHIP = dict(width=64, num_heads=4, ffn_width=128, num_layers=2)  # __graft_entry__.py:26
ENTRY_SHAPE = (2, 12)  # B, S = nf x ne = 4 x 3 (__graft_entry__.py:27)
MAX_FACE, MAX_EDGE = 10, 8  # the dry run's batch (__graft_entry__.py:127)
TINY = dict(width=32, num_heads=2, ffn_width=64, num_layers=1)  # _tiny_cascade
TINY_CASCADE = dict(num_surfaces=4, num_edges=3, pndm_steps=10, pos_pndm_calls=8,
                    ddpm_tail=5)
SAMPLING_TOL = 1e-4  # rtol = atol, __graft_entry__.py:278
BATCH_KEYS = ("edgepnt", "edgepos", "edge_mask", "surfpnt", "surfpos", "vertpos")
B1 = 0.95  # the LDM optimizer's first-moment decay: AdamW's exp_avg is (1 - b1) g
# a gradient element above this (100 x Adam's eps) is resolved: below it both
# steps compute rounding noise, which Adam's first step moves by up to lr
LIVE_GRAD = 1e-6
RANK_TIMEOUT = 1800


def _device(device) -> torch.device:
    return resolve_device("cuda" if device is None else device)


def entry(device=None):
    """``(fn, (streams, t, mask))``: the flagship edgez denoiser's forward and
    its example inputs, on the card unless ``device="cpu"``."""
    dev = _device(device)
    net = seed_weights(tden.make_edgez_net(attn_impl="kernel", **FLAGSHIP),
                       torch.Generator().manual_seed(0)).to(dev).eval()
    rng = np.random.default_rng(0)
    B, S = ENTRY_SHAPE
    streams = tuple(torch.from_numpy(rng.normal(size=(B, S, d)).astype(np.float32)).to(dev)
                    for d in net.stream_dims.values())
    t = torch.tensor([7, 613], device=dev)
    mask = torch.zeros((B, S), dtype=torch.bool)
    mask[1, 8:] = True  # sample 1: 8 of 12 slots
    return net, (streams, t, mask.to(dev))


def train_batch(batch_size: int) -> dict:
    """The dry run's global batch: ``batch_size`` synthetic solids
    (``make_dataset(B, seed=0)``) assembled for edgez at 10 x 8 slots with
    ``np.random.default_rng(0)``, as ``__graft_entry__.py:127-139``."""
    rng = np.random.default_rng(0)
    items = [assemble_edgez(d, rng, max_face=MAX_FACE, max_edge=MAX_EDGE)
             for d in make_dataset(batch_size, seed=0)]
    return {k: np.stack([it[i] for it in items]) for i, k in enumerate(BATCH_KEYS)}


def train_models(device, dropout: float = 0.1):
    """The dry run's seeded models on ``device``: the flagship edgez denoiser
    (kernel attention, ``dropout``) and the frozen VAEs of
    ``__graft_entry__.py:146-147``."""
    gen = torch.Generator().manual_seed(0)
    net = seed_weights(tden.make_edgez_net(attn_impl="kernel", dropout=dropout, **FLAGSHIP),
                       gen).to(device)
    surf_vae = seed_weights(SurfVAE((4, 4, 4, 4)), gen).to(device).eval()
    edge_vae = seed_weights(EdgeVAE((4, 4, 4)), gen).to(device).eval()
    return net, surf_vae, edge_vae


def train_step(batch: dict, device, mesh=None, draws=None, dropout: float = 0.1):
    """One edgez step of the dry run's models on ``batch`` (numpy, global):
    in one process (``mesh`` None), or this rank's share on a data x model
    ``mesh`` (the denoiser split over ``model``, the rows over ``data``, DDP
    over ``data``). Draws and dropout masks come from a generator seeded 1,
    or the draws from ``draws``. Returns (the denoiser, its TrainState, the
    step's metrics as floats)."""
    net, surf_vae, edge_vae = train_models(device, dropout)
    rows = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    model, split = net, None
    if mesh is not None:
        replicate(net, mesh)
        shard_denoiser(net, mesh)
        split = data_split(mesh)
        net.encoder.row_split = split
        model = data_parallel(net, mesh)
        rows = shard_batch(rows, mesh)
    state = TrainState(net, make_ldm_optimizer(net.parameters()))
    step = make_edgez_step(model, make_ddpm_tables(), make_encoder_fn(surf_vae),
                           make_encoder_fn(edge_vae), row_split=split)
    metrics = step(state, rows, torch.Generator().manual_seed(1), draws)
    return net, state, {k: float(v) for k, v in metrics.items()}


def clipped_grads(state: TrainState) -> dict:
    """{name: the step's clipped gradient}, read back from AdamW's first
    moment (1 - b1) g."""
    moments = state.optimizer.adamw.state
    return {n: moments[p]["exp_avg"] / (1 - B1) for n, p in state.module.named_parameters()}


def _train_leg(n: int, device: torch.device) -> dict:
    rank, _ = rank_and_world()
    model_par = 2 if n % 2 == 0 and n >= 4 else 1
    mesh = make_mesh((n // model_par, model_par), ("data", "model"), device_type=device.type)
    B = n // model_par * 2
    batch = train_batch(B)
    reset_launch_counts()
    net, state, metrics = train_step(batch, device, mesh)
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = {k: LAUNCH_COUNTS[k] for k in ("packed_attention", "packed_attention_backward")}
    if not np.isfinite(metrics["loss"]):
        raise AssertionError(f"dryrun_multichip[train]: rank {rank}: loss {metrics['loss']}")
    params = dict(net.named_parameters())
    grads = clipped_grads(state)
    # the replicated parameters' gradients on the model ranks: equal
    repl_diff = 0.0
    for k, g in grads.items():
        if model_par > 1 and getattr(params[k], "model_group", None) is None:
            parts = all_gather(g, mesh.get_group("model"))
            repl_diff = max(repl_diff, max((p - parts[0]).abs().max().item() for p in parts))
    full_grads = {k: gather_model(params[k], g).cpu() for k, g in grads.items()}
    full_params = {k: gather_model(p, p.detach()).cpu() for k, p in params.items()}
    norm = float(state.optimizer.last_norm)
    all_launches = [None] * n
    dist.all_gather_object(all_launches, launches)
    report = None
    if rank == 0:
        report = dict(mesh=[["data", n // model_par], ["model", model_par]], B=B,
                      metrics=metrics, norm=norm, launches=all_launches,
                      replicated_grad_max_diff=repl_diff)
        ref, ref_state, ref_metrics = train_step(batch, device)
        ref_grads = {k: g.cpu() for k, g in clipped_grads(ref_state).items()}
        report.update(ref_metrics=ref_metrics, ref_norm=float(ref_state.optimizer.last_norm),
                      **compare_steps(full_grads, full_params, ref_grads,
                                      {k: p.detach().cpu() for k, p in ref.named_parameters()}))
        print(f"dryrun_multichip[train]: mesh={tuple(map(tuple, report['mesh']))} B={B} "
              f"loss={metrics['loss']:.4f} (one process {ref_metrics['loss']:.4f}); clip norm "
              f"{norm:.6f} / {report['ref_norm']:.6f}; gradients gathered over model: max abs "
              f"diff {report['grad_max_abs_diff']:.3e}; parameters where the gradient is "
              f"resolved {report['param_max_abs_diff']:.3e}; replicated gradients equal on the "
              f"model ranks to {repl_diff:.3e}; K1/K5 launches a rank "
              + ", ".join(f"{d['packed_attention']}/{d['packed_attention_backward']}"
                          for d in all_launches), flush=True)
    dist.barrier()
    return report


def compare_steps(grads: dict, params: dict, ref_grads: dict, ref_params: dict) -> dict:
    """How far a split step's unsharded gradients and updated parameters lie
    from the single-process step's: per tensor the max abs gradient
    difference, and the max abs parameter difference where the gradient is
    resolved (|g| above ``LIVE_GRAD`` and above the two steps' difference)
    and elsewhere."""
    grad_diff = {k: (grads[k] - g).abs().max().item() for k, g in ref_grads.items()}
    live_diff, dead_diff, dead = {}, {}, 0
    for k, v in ref_params.items():
        diff = (params[k] - v).abs()
        g = ref_grads[k].abs()
        live = (g > LIVE_GRAD) & (g > (grads[k] - ref_grads[k]).abs())
        dead += int((~live).sum())
        live_diff[k] = diff[live].max().item() if live.any() else 0.0
        dead_diff[k] = diff[~live].max().item() if (~live).any() else 0.0

    def norm(ts):
        return float(torch.sqrt(sum((t.double() ** 2).sum() for t in ts)))

    return dict(grad_max_abs_diff=max(grad_diff.values()), grad_diff=grad_diff,
                grad_rel=norm(grads[k] - g for k, g in ref_grads.items()) / norm(
                    ref_grads.values()),
                param_max_abs_diff=max(live_diff.values()), param_diff=live_diff,
                param_max_abs_diff_unresolved=max(dead_diff.values()),
                unresolved_elements=dead)


def tiny_cascade(batch_size: int, device, row_split=None) -> Cascade:
    """``_tiny_cascade`` of ``__graft_entry__.py:191-248`` with seeded
    weights: the four denoisers at width 32 with 2 heads (the edge stages on
    the kernel route), the VAEs at (4, 4, 4, 4) and (4, 4, 4), PNDM 10 + DDPM
    5 over 4 faces x 3 edges; this rank's rows with a ``row_split``."""
    gen = torch.Generator().manual_seed(0)
    nets = {s: seed_weights(getattr(tden, f"make_{s}_net")(
        attn_impl="kernel" if s.startswith("edge") else "plain", **TINY), gen).to(device).eval()
        for s in ("surfpos", "surfz", "edgepos", "edgez")}
    vaes = [seed_weights(v, gen).to(device).eval()
            for v in (SurfVAE((4, 4, 4, 4)), EdgeVAE((4, 4, 4)))]
    rows = batch_size if row_split is None else batch_size // row_split.world
    return Cascade(nets, *vaes, CascadeConfig(batch_size=rows, **TINY_CASCADE),
                   row_split=row_split)


def _sampling_leg(n: int, device: torch.device) -> dict:
    """The tiny cascade split over the n ranks on ``data`` (B = n), against
    the unsharded cascade on rank 0."""
    rank, _ = rank_and_world()
    split = RowSplit(rank, n)
    noise = GeneratorNoise(torch.Generator(device=device).manual_seed(0))
    reset_launch_counts()
    with torch.no_grad():
        out = tiny_cascade(n, device, split)(RowNoise(noise, split))
    k1 = LAUNCH_COUNTS["packed_attention"]
    parts = [None] * n
    dist.all_gather_object(parts, ({k: v.cpu().numpy() for k, v in out.items()}, k1))
    report = None
    if rank == 0:
        with torch.no_grad():
            want = tiny_cascade(n, device)(GeneratorNoise(
                torch.Generator(device=device).manual_seed(0)))
        diffs = {}
        for k, v in want.items():
            a = v.cpu().numpy().astype(np.float32)
            b = np.concatenate([p[0][k] for p in parts]).astype(np.float32)
            np.testing.assert_allclose(b, a, rtol=SAMPLING_TOL, atol=SAMPLING_TOL, err_msg=k)
            diffs[k] = float(np.abs(b - a).max()) if a.size else 0.0
        diff = max(diffs.values())
        report = dict(B=n, outputs=len(want), max_abs_diff=diff, diffs=diffs,
                      k1_per_rank=[p[1] for p in parts])
        print(f"dryrun_multichip[sampling]: {n}-way split cascade matches unsharded (B={n}, "
              f"{len(want)} outputs, max abs diff {diff:.3e}, rtol = atol = {SAMPLING_TOL:g}); "
              f"K1 a rank {report['k1_per_rank']}; sampling is split on data only "
              "(embarrassingly parallel across solids)", flush=True)
    dist.barrier()
    return report


def dryrun_multichip(n_devices: int, device=None) -> Optional[dict]:
    """The train and sampling legs over ``n_devices`` ranks; returns rank 0's
    report (None on the other ranks of an existing group)."""
    if in_group():
        _, world = rank_and_world()
        if world != n_devices:
            raise ValueError(f"dryrun_multichip({n_devices}) in a group of {world} ranks")
        dev = _device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        train = _train_leg(n_devices, dev)
        sampling = _sampling_leg(n_devices, dev)
        return None if train is None else dict(train=train, sampling=sampling)
    return _launch_ranks(n_devices, device)


def _launch_ranks(n: int, device) -> dict:
    """Start ``n`` ranks of this module, wait for all, return rank 0's report."""
    cpu = device is not None and torch.device(device).type == "cpu"
    if cpu:
        backend = "gloo"
    else:
        cards = torch.cuda.device_count()
        if not cards:
            raise RuntimeError("dryrun_multichip: no CUDA device is visible; pass device='cpu' "
                               "to run the ranks on the CPU (gloo)")
        backend = "nccl" if cards >= n else "gloo"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    if cpu:
        env["OMP_NUM_THREADS"] = "1"
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{os.path.join(tmp, 'rendezvous')}"
        out = os.path.join(tmp, "report.json")
        procs = [subprocess.Popen(
            [sys.executable, "-m", "brepgen_tpu_torch.graft_entry", "--rank", str(r),
             "--world", str(n), "--init", init, "--backend", backend,
             "--device", "cpu" if cpu else "cuda", "--out", out],
            cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(n)]
        logs = [p.communicate(timeout=RANK_TIMEOUT)[0] for p in procs]
        sys.stdout.write(logs[0])
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise RuntimeError(f"dryrun_multichip: rank {r} of {n} ({backend}) exited "
                                   f"{p.returncode}:\n{log[-4000:]}")
        with open(out) as f:
            report = json.load(f)
    report["backend"] = backend
    return report


def _rank_main(args) -> int:
    """One rank of ``dryrun_multichip``: join the group, run both legs, and
    rank 0 writes the report to ``args.out``."""
    if args.device == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(args.rank % torch.cuda.device_count())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(args.backend, init_method=args.init, rank=args.rank,
                            world_size=args.world)
    try:
        report = dryrun_multichip(args.world, args.device)
        if args.rank == 0:
            with open(args.out, "w") as f:
                json.dump(report, f)
    finally:
        dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None, help="cpu, or the card (default)")
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--world", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--init", default=None, help=argparse.SUPPRESS)
    p.add_argument("--backend", default=None, help=argparse.SUPPRESS)
    p.add_argument("--out", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.rank is not None:
        return _rank_main(args)
    fn, fargs = entry(args.device)
    with torch.no_grad():
        out = fn(*fargs)
    print("entry ok:", tuple(out.shape), flush=True)
    cpu = args.device is not None and torch.device(args.device).type == "cpu"
    dryrun_multichip(1 if cpu else max(1, torch.cuda.device_count()), args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
