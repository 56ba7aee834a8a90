"""VAE training CLI: flag parity with ``brepgen_tpu/cli/vae_main.py:26-51``
(reference ``vae.py`` + ``utils.py:148-173``), plus ``--device``.

    python -m brepgen_tpu_torch.cli.vae_main --option surface|edge \\
        --train_list LIST_surface.pkl --val_list LIST.pkl --data DIR [--bf16] \\
        [--synthetic N] [--small] [--device cpu]

Trains the surface (2D) or edge (1D) VAE on the flat array of deduplicated
grids that ``eval_main dedup --list`` writes (or, with ``--synthetic N``, on
the deduplicated primitives of N synthetic solids), validates on every grid
of the val solids every ``--test_nepoch`` epochs, and writes
``<dir_name>/<env>/epoch_N.npz`` (the pack format both packages load), a
resume file ``latest.pt`` and ``<env>.jsonl`` metrics. Each epoch draws a
permutation from ``default_rng(seed)`` and drops the last partial batch, as
the JAX CLI does: a set smaller than ``--batch_size`` trains no step.
``--bf16`` runs the VAE under ``torch.autocast`` in bf16 over f32
parameters and optimizer state (AdamW lr 5e-4, wd 1e-5, global-norm clip
5.0). Runs on the card (``--device cuda``, the default; raises without one)
or the CPU.
"""

from __future__ import annotations

import argparse
import os
import pickle
import time
from typing import List, Optional

import numpy as np
import torch

from brepgen_tpu_torch import resolve_device
from brepgen_tpu_torch.cli.build import build_vae, seed_weights, uid_to_path
from brepgen_tpu_torch.data.assembly import assemble_edge_u, assemble_surf_uv
from brepgen_tpu_torch.data.dedup import dedup_primitives
from brepgen_tpu_torch.data.loader import flat_vae_batcher, prefetch_to_device
from brepgen_tpu_torch.data.synthetic import make_dataset
from brepgen_tpu_torch.train import vae_train
from brepgen_tpu_torch.train.checkpoint import load_params, load_resume
from brepgen_tpu_torch.train.common import TrainState, make_vae_optimizer
from brepgen_tpu_torch.train.logging import MetricsLogger
from brepgen_tpu_torch.train.loop import RESUME_FILE, run_training


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--data", type=str, default="data_process/deepcad_parsed")
    p.add_argument("--train_list", type=str,
                   default="data_process/deepcad_data_split_6bit_surface.pkl")
    p.add_argument("--val_list", type=str, default="data_process/deepcad_data_split_6bit.pkl")
    p.add_argument("--option", type=str, choices=["surface", "edge"], default="surface")
    p.add_argument("--batch_size", type=int, default=512)
    p.add_argument("--train_nepoch", type=int, default=200)
    p.add_argument("--save_nepoch", type=int, default=20)
    p.add_argument("--test_nepoch", type=int, default=10)
    p.add_argument("--data_aug", action="store_true")
    p.add_argument("--finetune", action="store_true")
    p.add_argument("--weight", type=str, default=None)
    p.add_argument("--gpu", type=int, nargs="+", default=[0])  # accepted, unused
    p.add_argument("--env", type=str, default="surface_vae")
    p.add_argument("--dir_name", type=str, default="proj_log")
    p.add_argument("--synthetic", type=int, default=0,
                   help="train on N synthetic solids instead of extracted data")
    p.add_argument("--bf16", action="store_true", help="bf16 compute (autocast)")
    p.add_argument("--small", action="store_true", help="tiny debug architecture")
    p.add_argument("--resume", action="store_true",
                   help=f"resume from <save_dir>/{RESUME_FILE} if present")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    args.save_dir = f"{args.dir_name}/{args.env}"
    return args


def grid_key(option: str) -> str:
    return "surf_ncs" if option == "surface" else "edge_ncs"


def load_train_array(args) -> np.ndarray:
    """The flat training array: the deduplicated primitives of the
    synthetic solids, or the array pickled at ``--train_list``."""
    if args.synthetic:
        return dedup_primitives(make_dataset(args.synthetic, seed=args.seed),
                                args.option).astype(np.float32)
    with open(args.train_list, "rb") as f:
        return np.asarray(pickle.load(f), np.float32)


def load_val_array(args) -> np.ndarray:
    """Every grid of the val solids (synthetic: a tenth as many, from the
    next seed), concatenated."""
    if args.synthetic:
        ds = make_dataset(max(args.synthetic // 10, 2), seed=args.seed + 1)
        return np.concatenate([d[grid_key(args.option)] for d in ds]).astype(np.float32)
    with open(args.val_list, "rb") as f:
        uids = pickle.load(f)["val"]
    out = []
    for uid in uids:
        with open(uid_to_path(args.data, uid), "rb") as f:
            out.append(pickle.load(f)[grid_key(args.option)])
    return np.concatenate(out).astype(np.float32)


def make_aug_fn(option: str):
    """``--data_aug``: each grid through the port's assembly with ``aug``
    on, in batch order, drawing from the epoch rng (``vae_main.py:122-126``)."""
    assemble, key = (assemble_surf_uv if option == "surface" else assemble_edge_u), grid_key(option)

    def aug(batch: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        return np.stack([assemble({key: g[None]}, rng, aug=True)[0] for g in batch])

    return aug


def build_model(args) -> torch.nn.Module:
    return build_vae(args.option, "small" if args.small else "production")


def train(args) -> TrainState:
    device = resolve_device(args.device)
    os.makedirs(args.save_dir, exist_ok=True)
    compute_dtype = torch.bfloat16 if args.bf16 else None
    model = seed_weights(build_model(args), torch.Generator().manual_seed(args.seed))
    if args.finetune and args.weight:
        load_params(args.weight, model)
    model = model.to(device)

    train_data = load_train_array(args)
    val_data = load_val_array(args)
    print(f"train items: {len(train_data)}, val items: {len(val_data)}")

    state = TrainState(model, make_vae_optimizer(model.parameters()))
    generator = torch.Generator().manual_seed(args.seed + 1)  # posterior draws
    resume = os.path.join(args.save_dir, RESUME_FILE)
    if args.resume and os.path.isfile(resume):
        load_resume(resume, state, {"train": generator})
        print(f"resumed from step {state.step}")
    train_step = vae_train.make_train_step(model, compute_dtype)
    eval_step = vae_train.make_eval_step(model, compute_dtype)
    epoch = flat_vae_batcher(train_data, args.batch_size, seed=args.seed,
                             aug_fn=make_aug_fn(args.option) if args.data_aug else None)

    def step(state, batch, generator):
        return train_step(state, batch[0], generator)

    def val_fn(state):
        total, count = 0.0, 0
        for start in range(0, len(val_data), args.batch_size):
            vb = torch.from_numpy(val_data[start: start + args.batch_size]).to(device)
            total += float(eval_step(vb, generator))
            count += len(vb)
        print(f"step {state.step}: val mse {total / max(count, 1):.6f}", flush=True)
        return {"Val-mse": total / max(count, 1)}

    with MetricsLogger(args.save_dir, args.env) as logger:
        t0 = time.perf_counter()
        run_training(step, lambda: prefetch_to_device(((b,) for b in epoch()), device), state,
                     epochs=args.train_nepoch, generator=generator, logger=logger,
                     ckpt_dir=args.save_dir, val_fn=val_fn, test_nepoch=args.test_nepoch,
                     save_nepoch=args.save_nepoch)
        print(f"trained the {args.option} VAE: {state.step} steps in "
              f"{time.perf_counter() - t0:.2f} s; metrics in {logger.path}", flush=True)
    return state


def main(argv: Optional[List[str]] = None) -> TrainState:
    return train(get_args(argv))


if __name__ == "__main__":
    main()
