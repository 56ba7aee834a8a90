"""Train-step throughput: plain attention against the kernels (forward and
backward).

Port of ``scripts/train_attn_bench.py``. Times the full edgez train step
(frozen VAE encodes, the denoiser's forward and backward, the clipped AdamW
update) at the DeepCAD production shape (B=128, 30 faces x 20 edges = 600
tokens) in bf16, with seeded weights, once through plain attention and once
through the kernels (K1 forward, K5 backward in every layer)::

    python -m brepgen_tpu_torch.tools.train_step_bench [--steps 15] [--device cpu]
        [--small]

One step warms up, then ``--steps`` are timed by the host clock around a
closing synchronise. Prints the report as one JSON line after each leg:
``edgez_bs128_{plain,kernel}_ms`` and ``_steps_per_s``. The JAX script
catches a failing leg into an "err: ..." string; here a failure raises, so
a kernel that fails cannot hide behind a printed string. The card's name and
power limit go to stderr.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from brepgen_tpu_torch import card, card_line, resolve_device

B, NF, NE = 128, 30, 20


def build_batch(batch_size: int, nf: int, ne: int,
                device: torch.device) -> Dict[str, torch.Tensor]:
    """The JAX script's batch: N(0, 1) grids and boxes from seed 0, no edge masked."""
    rng = np.random.default_rng(0)
    f32 = lambda *s: torch.as_tensor(rng.normal(size=s).astype(np.float32), device=device)  # noqa
    return {
        "edgepnt": f32(batch_size, nf, ne, 32, 3),
        "edgepos": f32(batch_size, nf, ne, 6),
        "edge_mask": torch.zeros((batch_size, nf, ne), dtype=torch.bool, device=device),
        "surfpnt": f32(batch_size, nf, 32, 32, 3),
        "surfpos": f32(batch_size, nf, 6),
        "vertpos": f32(batch_size, nf, ne, 6),
    }


def frozen_encoders(device: torch.device, arch: str) -> Tuple[Callable, Callable]:
    """The surface and edge VAEs' bf16 encodes, seeded, frozen."""
    from brepgen_tpu_torch.cli.build import build_vae, seed_weights
    from brepgen_tpu_torch.train.vae_train import make_encoder_fn

    gen = torch.Generator().manual_seed(0)
    encoders = []
    for option in ("surface", "edge"):
        vae = seed_weights(build_vae(option, arch), gen).to(device).eval().requires_grad_(False)
        encoders.append(make_encoder_fn(vae, torch.bfloat16))
    return tuple(encoders)


def edgez_step(device: torch.device, attn_impl: str, arch: str, remat=False,
               encoders=None) -> Callable[[Dict[str, torch.Tensor]], torch.Tensor]:
    """run(batch) -> loss: one bf16 edgez train step of a seeded denoiser
    (``train/ldm_train.py:make_edgez_step``) with its own optimizer state and
    draws; ``encoders`` the frozen encodes (built when None)."""
    from brepgen_tpu_torch.cli.build import build_denoiser, seed_weights
    from brepgen_tpu_torch.diffusion.ddpm import make_ddpm_tables
    from brepgen_tpu_torch.train import ldm_train
    from brepgen_tpu_torch.train.common import TrainState, make_ldm_optimizer

    model = build_denoiser("edgez", arch=arch, attn_impl=attn_impl, remat=remat)
    model = seed_weights(model, torch.Generator().manual_seed(0)).to(device)
    state = TrainState(model, make_ldm_optimizer(model.parameters()))
    surf_encode, edge_encode = encoders or frozen_encoders(device, arch)
    step = ldm_train.make_edgez_step(model, make_ddpm_tables(), surf_encode, edge_encode,
                                     compute_dtype=torch.bfloat16)
    generator = torch.Generator().manual_seed(1)
    return lambda batch: step(state, batch, generator)["loss"]


def steps_seconds(run: Callable, batch, n_steps: int, device: torch.device) -> float:
    """Seconds per step of ``n_steps`` after one warm-up step (host clock,
    synchronised); raises on a non-finite loss."""
    run(batch)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(n_steps):
        loss = run(batch)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = (time.perf_counter() - t0) / n_steps
    if not np.isfinite(float(loss)):
        raise RuntimeError(f"non-finite loss {float(loss)}")
    return seconds


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--small", action="store_true", help="the tiny debug architecture")
    p.add_argument("--steps", type=int, default=15, help="timed steps a leg")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    print(card_line(card(dev)), file=sys.stderr, flush=True)
    arch = "small" if args.small else "production"
    batch = build_batch(B, NF, NE, dev)
    encoders = frozen_encoders(dev, arch)
    report = {}
    for attn in ("plain", "kernel"):
        dt = steps_seconds(edgez_step(dev, attn, arch, encoders=encoders), batch, args.steps,
                           dev)
        report[f"edgez_bs{B}_{attn}_ms"] = dt * 1e3
        report[f"edgez_bs{B}_{attn}_steps_per_s"] = 1 / dt
        print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
