"""Host input pipeline against the device train step.

Port of ``scripts/io_bench.py``. At the DeepCAD production shapes it
measures:

  * the host batch assembly rate (``data/loader.py:Batcher`` with the
    ``data/assembly.py`` functions) with 0 and 8 worker processes, and with
    the whole-batch assembly (``data/batch_assembly.py``), in batches/s;
  * the device train-step rate of surfpos at B=512 and edgez at B=128
    (production width, bf16, seeded; the frozen VAE encodes inside the edgez
    step, then with the latents cached by ``data/latent_cache.py``), in
    steps/s, with ``--remat auto``'s policy (``cli/build.py:auto_remat``) and
    the attention the training CLI takes (plain for surfpos, the kernels for
    edgez: K1 forward, K5 backward);

and the ratio of the two (host >= device: the device is never starved)::

    python -m brepgen_tpu_torch.tools.io_bench [cached_only] [--device cpu] [--small]
        [--steps 20]

``cached_only`` runs only the edgez cached-latents device leg. The report
(printed as one JSON line after each leg) holds ``host_cpus`` and, beside the
JAX script's keys, ``device``, the card's name ("cpu" off the card); its
power limit goes to stderr.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

import numpy as np
import torch

from brepgen_tpu_torch import card, card_line, resolve_device
from brepgen_tpu_torch.tools.train_step_bench import (
    build_batch,
    edgez_step,
    frozen_encoders,
    steps_seconds,
)

NF, NE = 30, 20  # deepcad training shapes (train_ldm.sh:5-6)
SURFPOS_BS, EDGEZ_BS = 512, 128
WORKERS = (0, 8)  # worker processes of the per-solid host legs
BATCHES = 8       # timed host batches a leg


def host_rate(ds, option: str, batch_size: int, workers: int, batched: bool = False) -> float:
    """Batches/s of the Batcher on the solids ``ds`` after one warm-up batch
    (which includes the process pool's start)."""
    from brepgen_tpu_torch.data import batch_assembly as BA
    from brepgen_tpu_torch.data.assembly import assemble_edgez, assemble_surfpos
    from brepgen_tpu_torch.data.loader import Batcher

    if option == "surfpos":
        kw = dict(max_face=NF, bbox_scaled=3.0, aug=True)
        asm, basm = assemble_surfpos, BA.assemble_surfpos_batched
    else:
        kw = dict(max_face=NF, max_edge=NE, bbox_scaled=3.0, aug=True)
        asm, basm = assemble_edgez, BA.assemble_edgez_batched
    # clamp_to_cpus=False: measure the pool even on a host with few cores
    # (the training Batcher clamps it away there, and this bench says why)
    b = Batcher(ds, functools.partial(asm, **kw), batch_size, num_workers=workers,
                drop_last=False, clamp_to_cpus=False,
                batch_assemble_fn=functools.partial(basm, **kw) if batched else None)
    try:
        it = iter(b)
        next(it)
        t0 = time.perf_counter()
        n = 0
        while n < BATCHES:
            try:
                next(it)
                n += 1
            except StopIteration:
                it = iter(b)
        return n / (time.perf_counter() - t0)
    finally:
        b.close()


def device_rate(option: str, batch_size: int, device: torch.device, arch: str,
                n_steps: int = 20, cached_latents: bool = False) -> float:
    """Steps/s of the bf16 train step of ``option`` after one warm-up step."""
    from brepgen_tpu_torch.cli.build import auto_remat, build_denoiser, seed_weights
    from brepgen_tpu_torch.diffusion.ddpm import make_ddpm_tables
    from brepgen_tpu_torch.train import ldm_train
    from brepgen_tpu_torch.train.common import TrainState, make_ldm_optimizer

    remat = auto_remat(option, batch_size, NF, NE)
    if option == "surfpos":
        model = build_denoiser("surfpos", arch=arch, remat=remat)
        model = seed_weights(model, torch.Generator().manual_seed(0)).to(device)
        state = TrainState(model, make_ldm_optimizer(model.parameters()))
        step = ldm_train.make_surfpos_step(model, make_ddpm_tables(),
                                           compute_dtype=torch.bfloat16)
        generator = torch.Generator().manual_seed(1)
        rng = np.random.default_rng(0)
        batch = {"surfpos": torch.as_tensor(
            rng.normal(size=(batch_size, NF, 6)).astype(np.float32), device=device)}
        run = lambda b: step(state, b, generator)["loss"]  # noqa: E731
    else:
        batch = build_batch(batch_size, NF, NE, device)
        surf_encode, edge_encode = frozen_encoders(device, arch)
        if cached_latents:
            # steady-state --cache_latents: the frozen encodes hoisted off the
            # step (a hot cache holds the latents of the fixed batch)
            from brepgen_tpu_torch.data.latent_cache import LatentCache

            sc = LatentCache(surf_encode, (32, 32, 3), 48, batch_size * NF, device)
            ec = LatentCache(edge_encode, (32, 3), 12, batch_size * NF * NE, device)
            z = sc(batch.pop("surfpnt").reshape(-1, 32, 32, 3).cpu().numpy())
            batch["surfz"] = torch.as_tensor(z.reshape(batch_size, NF, 48), device=device)
            z = ec(batch.pop("edgepnt").reshape(-1, 32, 3).cpu().numpy())
            batch["edgez"] = torch.as_tensor(z.reshape(batch_size, NF, NE, 12), device=device)
        run = edgez_step(device, "kernel", arch, remat, (surf_encode, edge_encode))
    return 1.0 / steps_seconds(run, batch, n_steps, device)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("cached_only", nargs="?", choices=("cached_only",),
                   help="only the edgez cached-latents device leg")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--small", action="store_true", help="the tiny debug architecture")
    p.add_argument("--steps", type=int, default=20, help="timed device steps a leg")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    info = card(dev)
    print(card_line(info), file=sys.stderr, flush=True)
    arch = "small" if args.small else "production"
    report = {"host_cpus": os.cpu_count(), "device": info["device"]}
    if args.cached_only:
        r = device_rate("edgez", EDGEZ_BS, dev, arch, args.steps, cached_latents=True)
        report[f"device_edgez_bs{EDGEZ_BS}_cached_latents_steps_per_s"] = r
        print(json.dumps(report), flush=True)
        return report
    from brepgen_tpu_torch.data.synthetic import make_dataset

    for option, bs in (("surfpos", SURFPOS_BS), ("edgez", EDGEZ_BS)):
        ds = make_dataset(max(bs, 256), seed=0)  # synthetic solids
        for workers in WORKERS:
            r = host_rate(ds, option, bs, workers)
            report[f"host_{option}_bs{bs}_w{workers}_batches_per_s"] = r
        r = host_rate(ds, option, bs, 0, batched=True)
        report[f"host_{option}_bs{bs}_batched_batches_per_s"] = r
        print(json.dumps(report), flush=True)
        r = device_rate(option, bs, dev, arch, args.steps)
        report[f"device_{option}_bs{bs}_steps_per_s"] = r
        host = report[f"host_{option}_bs{bs}_batched_batches_per_s"]
        report[f"{option}_host_over_device"] = host / r
        print(json.dumps(report), flush=True)
        if option == "edgez":
            r = device_rate(option, bs, dev, arch, args.steps, cached_latents=True)
            report[f"device_{option}_bs{bs}_cached_latents_steps_per_s"] = r
            print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
