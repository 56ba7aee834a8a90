"""LDM training CLI: flag parity with ``brepgen_tpu/cli/ldm_main.py:47-99``
(reference ``ldm.py`` + ``utils.py:176-207``), plus ``--device``.

    python -m brepgen_tpu_torch.cli.ldm_main --option edgez --bf16 \\
        --surfvae PACK.npz --edgevae PACK.npz [--synthetic N] [--device cpu]

Trains one of the four denoisers on the card (``--device cuda``, the
default) or the CPU. The edge stages attend through the CUDA kernels: K1
forward and K5 backward in every layer of every step. The frozen VAEs come
from npz packs (``--surfvae``/``--edgevae``, the extension may be left off)
at the architecture the pack holds. ``--bf16`` runs the step under
``torch.autocast`` in bf16 over f32 parameters and optimizer state; the
frozen encodes run in the same type wherever they run. Writes
``<dir_name>/<env>/epoch_N.npz`` (the format both packages load), a resume
file ``latest.pt`` and ``<env>.jsonl`` metrics.

``--cache_latents`` encodes each distinct face and edge grid once, in the
batch producer's thread, and hands the steps the latents (refused with
``--data_aug``); ``--profile DIR`` writes a ``torch.profiler`` trace of
steps 10-29 (or to the end of their epoch) to ``DIR/trace.json`` and prints
the device idle share; ``--remat dots`` keeps the outputs of the dense
products and recomputes the rest of each layer in the backward.

``--dp`` trains data-parallel over the processes of a torchrun launch, one
card each (NCCL; gloo with ``--device cpu``)::

    torchrun --nproc_per_node N -m brepgen_tpu_torch.cli.ldm_main --dp ...

``--batch_size`` is the global batch, which must divide among the N ranks.
Each rank assembles its rows of every batch (the same draws per sample as
one process), the model is wrapped in ``DistributedDataParallel``, losses
are the global batch's masked means and the step's draws (noise, timesteps,
dropout masks, label drops) are the global batch's, so N ranks take the
step one process takes on the whole batch. Rank 0 writes the packs, the
resume file, the metrics and the ``--profile`` trace. Unlike the JAX CLI,
which trains on one device where a mesh is impossible, ``--dp`` outside a
torchrun launch, or with a batch that does not divide, exits with a message.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import pickle
import time
from dataclasses import dataclass
from typing import List, Optional

import torch

from brepgen_tpu_torch import resolve_device
from brepgen_tpu_torch.cli.build import (
    ARCHS,
    auto_remat,
    build_denoiser,
    resolve_samples,
    seed_weights,
    vae_channels_of_pack,
)
from brepgen_tpu_torch.data import batch_assembly as BA
from brepgen_tpu_torch.data.assembly import (
    assemble_edgepos,
    assemble_edgez,
    assemble_surfpos,
    assemble_surfz,
    filter_sample,
)
from brepgen_tpu_torch.data.latent_cache import LatentCache
from brepgen_tpu_torch.data.loader import Batcher, prefetch_to_device
from brepgen_tpu_torch.data.synthetic import make_dataset
from brepgen_tpu_torch.diffusion.ddpm import make_ddpm_tables
from brepgen_tpu_torch.kernels import LAUNCH_COUNTS
from brepgen_tpu_torch.nn import EdgeVAE, SurfVAE
from brepgen_tpu_torch.parallel.distributed import (
    TORCHRUN_HINT,
    RowSplit,
    all_reduce_sum,
    launched,
    maybe_initialize_distributed,
)
from brepgen_tpu_torch.train import ldm_train
from brepgen_tpu_torch.train.checkpoint import load_params, load_resume
from brepgen_tpu_torch.train.common import TrainState, make_ldm_optimizer
from brepgen_tpu_torch.train.logging import MetricsLogger, NullLogger
from brepgen_tpu_torch.train.loop import RESUME_FILE, run_training
from brepgen_tpu_torch.train.vae_train import make_encoder_fn
from brepgen_tpu_torch.utils.profiling import StepTrace

BATCH_KEYS = {
    "surfpos": ("surfpos",),
    "surfz": ("surfpos", "surfpnt", "surf_mask"),
    "edgepos": ("edgepos", "surfpnt", "surfpos", "surf_mask"),
    "edgez": ("edgepnt", "edgepos", "edge_mask", "surfpnt", "surfpos", "vertpos"),
}
SMALL = ARCHS["small"]["denoiser"]
DP_NEEDS_TORCHRUN = (f"ldm_main: --dp trains over the processes of a torchrun launch: run "
                     f"{TORCHRUN_HINT} -m brepgen_tpu_torch.cli.ldm_main --dp ...")
CACHE_NEEDS_NO_AUG = ("--cache_latents requires --data_aug off: rotation aug changes "
                      "surf_ncs/edge_ncs every epoch (dataset.py:322,499)")


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--data", type=str, default="data_process/deepcad_parsed")
    p.add_argument("--list", type=str, default="data_process/deepcad_data_split_6bit.pkl")
    p.add_argument("--surfvae", type=str, default="proj_log/deepcad_surfvae/epoch_400")
    p.add_argument("--edgevae", type=str, default="proj_log/deepcad_edgevae/epoch_300")
    p.add_argument("--option", type=str,
                   choices=["surfpos", "surfz", "edgepos", "edgez"], default="surfpos")
    p.add_argument("--batch_size", type=int, default=512)
    p.add_argument("--train_nepoch", type=int, default=3000)
    p.add_argument("--test_nepoch", type=int, default=25)
    p.add_argument("--save_nepoch", type=int, default=50)
    p.add_argument("--max_face", type=int, default=50)
    p.add_argument("--max_edge", type=int, default=30)
    p.add_argument("--threshold", type=float, default=0.05)
    p.add_argument("--bbox_scaled", type=float, default=3.0)
    p.add_argument("--z_scaled", type=float, default=1.0)
    p.add_argument("--gpu", type=int, nargs="+", default=[0, 1])  # accepted, unused
    p.add_argument("--data_aug", action="store_true")
    p.add_argument("--cf", action="store_true")
    p.add_argument("--env", type=str, default="surface_pos")
    p.add_argument("--dir_name", type=str, default="proj_log")
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--small", action="store_true", help="tiny debug architecture")
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--cache_latents", action="store_true",
                   help="encode each distinct grid once through the frozen VAEs (a host "
                        "content cache) instead of in every step; requires --data_aug off")
    p.add_argument("--profile", type=str, default=None,
                   help="torch.profiler trace dir: steps 10-29, or to the end of their "
                        "epoch; prints the device idle share")
    p.add_argument("--remat", choices=("auto", "on", "off", "dots"), default="auto",
                   help="per-layer recompute in the backward; auto turns it on when B x "
                        "tokens reaches 32768 (the edge stages at reference batch sizes); "
                        "'dots' saves the dense products' outputs and recomputes the rest")
    p.add_argument("--assembly", choices=("batched", "per_sample"), default="batched",
                   help="host batch assembly: one vectorized call per batch (default; "
                        "same draws as per-sample) or the per-sample path")
    p.add_argument("--dp", action="store_true",
                   help=f"data parallel over the ranks of a torchrun launch ({TORCHRUN_HINT}); "
                        "--batch_size is the global batch")
    p.add_argument("--log_every", type=int, default=10,
                   help="log the step's metrics every N steps (the JAX CLI's 10)")
    p.add_argument("--resume", action="store_true",
                   help=f"resume from <save_dir>/{RESUME_FILE} if present")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    args.save_dir = f"{args.dir_name}/{args.env}"
    return args


def refuse_unported(args) -> None:
    """Exit with a message for options that cannot run as given (the
    reference refuses them too, or they need a torchrun launch); it never
    falls back silently."""
    if args.cache_latents and args.data_aug:
        raise SystemExit(CACHE_NEEDS_NO_AUG)
    if args.dp and not launched():
        raise SystemExit(DP_NEEDS_TORCHRUN)


def join_group(args) -> Optional[RowSplit]:
    """Under ``--dp``, join torchrun's process group; this rank's split of
    the batch, or None without ``--dp``."""
    if not args.dp:
        return None
    maybe_initialize_distributed(device=args.device)
    split = RowSplit.of_group()
    if args.batch_size % split.world:
        raise SystemExit(f"ldm_main: --batch_size {args.batch_size} does not divide among "
                         f"{split.world} ranks")
    return split


def remat_of(args):
    """The denoiser's remat: "dots", True (on, or auto at production
    sizes) or False."""
    if args.remat == "dots":
        return "dots"
    return args.remat == "on" or (args.remat == "auto" and auto_remat(
        args.option, args.batch_size, args.max_face, args.max_edge))


def make_assemble_fn(args):
    # functools.partial of module-level functions: the Batcher ships it to
    # process-pool workers, so it must be picklable
    fn = {"surfpos": assemble_surfpos, "surfz": assemble_surfz,
          "edgepos": assemble_edgepos, "edgez": assemble_edgez}[args.option]
    kw = dict(max_face=args.max_face, bbox_scaled=args.bbox_scaled, aug=args.data_aug)
    if args.option.startswith("edge"):
        kw["max_edge"] = args.max_edge
    return functools.partial(fn, **kw)


def make_batch_assemble_fn(args):
    """Vectorized whole-batch twin of ``make_assemble_fn`` (same draws per
    (sample, seed))."""
    if args.assembly != "batched":
        return None
    fn = {"surfpos": BA.assemble_surfpos_batched, "surfz": BA.assemble_surfz_batched,
          "edgepos": BA.assemble_edgepos_batched, "edgez": BA.assemble_edgez_batched}
    kw = dict(max_face=args.max_face, bbox_scaled=args.bbox_scaled, aug=args.data_aug)
    if args.option.startswith("edge"):
        kw["max_edge"] = args.max_edge
    return functools.partial(fn[args.option], **kw)


def _filter_path(params):
    """Pool worker: open one pkl and apply the training-set filter."""
    path, max_face, max_edge, bbox_scaled, threshold = params
    with open(path, "rb") as f:
        d = pickle.load(f)
    return filter_sample(d, max_face, max_edge, bbox_scaled, threshold)


def load_filtered_samples(args, split):
    """(samples, class labels or None); samples are dicts or pkl paths."""
    if args.synthetic:
        n = args.synthetic if split == "train" else max(args.synthetic // 10, 2)
        ds = make_dataset(n, seed=args.seed + (0 if split == "train" else 1))
        kept = [d for d in ds if filter_sample(d, args.max_face, args.max_edge,
                                               args.bbox_scaled, args.threshold)]
        print(f"{split}: kept {len(kept)}/{len(ds)} synthetic solids")
        return kept, None

    paths, labels = resolve_samples(args.data, args.list, split)
    params = [(p, args.max_face, args.max_edge, args.bbox_scaled, args.threshold)
              for p in paths]
    if args.num_workers > 1 and len(paths) > 256:
        import multiprocessing

        with multiprocessing.get_context("spawn").Pool(args.num_workers) as pool:
            keep_flags = list(pool.imap(_filter_path, params, chunksize=64))
    else:
        keep_flags = [_filter_path(q) for q in params]
    kept = [paths[i] for i, keep in enumerate(keep_flags) if keep]
    kept_labels = ([labels[i] for i, keep in enumerate(keep_flags) if keep]
                   if labels is not None else None)
    print(f"{split}: kept {len(kept)}/{len(paths)}")
    # furniture inflation x50, keyed on the dataset layout (labels exist only
    # for furniture), as the JAX CLI does
    if split == "train" and labels is not None:
        kept, kept_labels = kept * 50, kept_labels * 50
    return kept, kept_labels


def to_batch(args, raw, surf_cache: Optional[LatentCache] = None,
             edge_cache: Optional[LatentCache] = None):
    """A Batcher tuple -> dict of numpy arrays keyed as the steps read them;
    with a cache, "surfpnt" / "edgepnt" give way to their latents "surfz"
    [B, nf, 48] / "edgez" [B, nf, ne, 12]."""
    keys = BATCH_KEYS[args.option]
    batch = dict(zip(keys, raw))
    if surf_cache is not None and "surfpnt" in batch:
        v = batch.pop("surfpnt")
        B, nf = v.shape[:2]
        batch["surfz"] = surf_cache(v.reshape(B * nf, 32, 32, 3)).reshape(B, nf, 48)
    if edge_cache is not None and "edgepnt" in batch:
        v = batch.pop("edgepnt")
        B, nf, ne = v.shape[:3]
        batch["edgez"] = edge_cache(v.reshape(B * nf * ne, 32, 3)).reshape(B, nf, ne, 12)
    if len(raw) > len(keys):  # trailing class labels
        batch["class_label"] = raw[len(keys)]
    return batch


def load_vae(option: str, path: str, device: torch.device):
    """A frozen VAE from an npz pack, at the widths the pack holds."""
    npz = path if path.endswith(".npz") else path + ".npz"
    if not os.path.isfile(npz):
        raise FileNotFoundError(f"{npz}: the frozen {option} VAE pack is missing")
    channels = vae_channels_of_pack(npz, option)
    vae = SurfVAE(block_out_channels=channels) if option == "surface" else \
        EdgeVAE(block_out_channels=channels)
    load_params(npz, vae)
    return vae.to(device).eval().requires_grad_(False)


@dataclass
class TrainRun:
    """What ``train`` leaves: the state, the validation calls it made (one
    per batch and fixed t), the metrics file, the latent caches
    (``--cache_latents``) and the trace window (``--profile``)."""

    state: TrainState
    val_calls: int = 0
    metrics_path: str = ""
    surf_cache: Optional[LatentCache] = None
    edge_cache: Optional[LatentCache] = None
    trace: Optional[StepTrace] = None


def train(args) -> TrainRun:
    refuse_unported(args)
    device = resolve_device(args.device)
    split = join_group(args)
    main_rank = split is None or split.rank == 0
    if split is not None and device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    os.makedirs(args.save_dir, exist_ok=True)
    compute_dtype = torch.bfloat16 if args.bf16 else None
    remat = remat_of(args)

    init_gen = torch.Generator().manual_seed(args.seed)
    kw = dict(SMALL) if args.small else {}
    model = build_denoiser(args.option, use_cf=args.cf, remat=remat, **kw)
    model = seed_weights(model, init_gen).to(device)
    tables = make_ddpm_tables()
    state = TrainState(model, make_ldm_optimizer(model.parameters()))
    net = model
    if split is not None:
        # this rank's dropout rows; DDP averages the gradients (a parameter
        # without one raises: find_unused_parameters is off)
        model.encoder.row_split = split
        net = torch.nn.parallel.DistributedDataParallel(
            model, device_ids=[device.index] if device.type == "cuda" else None,
            find_unused_parameters=False)

    surf_encode = edge_encode = None
    if args.option in ("surfz", "edgepos", "edgez"):
        surf_encode = make_encoder_fn(load_vae("surface", args.surfvae, device), compute_dtype)
    if args.option == "edgez":
        edge_encode = make_encoder_fn(load_vae("edge", args.edgevae, device), compute_dtype)

    generator = torch.Generator().manual_seed(args.seed + 2)
    resume = os.path.join(args.save_dir, RESUME_FILE)
    if args.resume and os.path.isfile(resume):
        load_resume(resume, state, {"train": generator})
        print(f"resumed from step {state.step}")

    step_fn = ldm_train.make_step(args.option, net, tables, surf_encode, edge_encode,
                                  args.cf, compute_dtype, split)
    val_step = ldm_train.make_val_step(args.option, model, tables, surf_encode, edge_encode,
                                       compute_dtype)

    train_samples, train_labels = load_filtered_samples(args, "train")
    val_samples, val_labels = load_filtered_samples(args, "val")
    assemble, batch_assemble = make_assemble_fn(args), make_batch_assemble_fn(args)
    batcher = Batcher(train_samples, assemble, args.batch_size, seed=args.seed,
                      class_labels=train_labels, num_workers=args.num_workers,
                      batch_assemble_fn=batch_assemble, row_split=split)
    val_batch = min(args.batch_size, max(len(val_samples), 1))
    val_batcher = Batcher(val_samples, assemble, val_batch, seed=args.seed,
                          class_labels=val_labels, drop_last=False,
                          batch_assemble_fn=batch_assemble, row_split=split)
    # the rows of each validation batch across all ranks
    val_rows = [min(val_batch, len(val_samples) - i) for i in range(0, len(val_samples),
                                                                     val_batch)]
    val_ts = (ldm_train.VAL_STEPS_SURF if args.option in ("surfpos", "surfz")
              else ldm_train.VAL_STEPS_EDGE)
    run = TrainRun(state)
    if args.cache_latents and surf_encode is not None:
        bucket = min(1024, args.batch_size * args.max_face)
        run.surf_cache = LatentCache(surf_encode, (32, 32, 3), 48, bucket, device)
        if edge_encode is not None:
            run.edge_cache = LatentCache(edge_encode, (32, 3), 12, bucket, device)
        print("latent cache enabled (frozen-VAE encodes hoisted off the step)")
    if args.profile is not None and main_rank:
        run.trace = StepTrace(args.profile)

    def batches(b):
        return (to_batch(args, raw, run.surf_cache, run.edge_cache) for raw in b)

    def epoch_iter():
        return prefetch_to_device(batches(batcher), device)

    def val_fn(state):
        metrics = {}
        for t_fixed in val_ts:
            total = count = 0.0
            for rows, batch in zip(val_rows, prefetch_to_device(batches(val_batcher), device)):
                if split is None:
                    s, c = val_step(batch, t_fixed, generator)
                else:  # the global batch's noise, this rank's rows
                    noise = torch.randn(ldm_train.target_shape(
                        args.option, rows, args.max_face, args.max_edge), generator=generator)
                    if not batch:
                        continue
                    s, c = val_step(batch, t_fixed, noise=split.take(noise))
                total += float(s)
                count += float(c)
                run.val_calls += 1
            if split is not None:
                total, count = all_reduce_sum(torch.tensor(
                    [total, count], dtype=torch.float64, device=device)).tolist()
            metrics[f"Val-{t_fixed:03d}"] = total / max(count, 1.0)
        if main_rank:
            print(f"step {state.step}: {metrics}", flush=True)
        return metrics

    try:
        with (MetricsLogger(args.save_dir, args.env) if main_rank else NullLogger()) as logger:
            run.metrics_path = logger.path
            t0 = time.perf_counter()
            run_training(step_fn, epoch_iter, state, epochs=args.train_nepoch,
                         generator=generator, logger=logger, ckpt_dir=args.save_dir,
                         val_fn=val_fn if len(val_samples) else None,
                         test_nepoch=args.test_nepoch, save_nepoch=args.save_nepoch,
                         log_every=args.log_every, trace=run.trace)
            if main_rank:
                ranks = "" if split is None else f" on each of {split.world} ranks"
                print(f"trained {args.option}: {state.step} steps and {run.val_calls} "
                      f"validation calls in {time.perf_counter() - t0:.2f} s; metrics in "
                      f"{logger.path}; kernel launches{ranks} {json.dumps(dict(LAUNCH_COUNTS))}",
                      flush=True)
    finally:
        batcher.close()
        val_batcher.close()
    return run


def main(argv: Optional[List[str]] = None) -> TrainState:
    args = get_args(argv)
    try:
        return train(args).state
    finally:
        if args.dp and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
