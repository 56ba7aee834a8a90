"""Generation CLI: ``python -m brepgen_tpu_torch.cli.sample_main --mode deepcad``.

Port of ``brepgen_tpu/cli/sample_main.py`` up to the raw cascade output:
builds the four denoisers and the two VAEs, fills them from npz packs
(``--weights_dir`` holding ``surfpos.npz``, ``surfz.npz``, ``edgepos.npz``,
``edgez.npz``, ``surf_vae.npz``, ``edge_vae.npz`` as ``train/checkpoint.py``
writes them, e.g. a ``ckpt_packed/`` folder; the architecture is read from
them) or with random weights at the production widths from ``--seed`` when
none are given, and runs the cascade batch by batch on the
card. Host postprocessing and STEP/STL export are not ported yet: the raw
batches go to ``<save_folder>/batches.npz`` as ``{key}__{batch}`` arrays, the
format ``scripts/replay_postprocess.py`` reads.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from brepgen_tpu_torch import resolve_device
from brepgen_tpu_torch.cli.build import arch_of_packs, build_denoiser, build_vae, seed_weights
from brepgen_tpu_torch.nn.layers import cast_compute
from brepgen_tpu_torch.sampling import Cascade, CascadeConfig, GeneratorNoise
from brepgen_tpu_torch.weights import load_flax_params

DENOISERS = ("surfpos", "surfz", "edgepos", "edgez")
PACKS = {"surface": "surf_vae.npz", "edge": "edge_vae.npz"}


def _materialise(make: Callable[[], torch.nn.Module], device: torch.device,
                 pack: Optional[str], generator: torch.Generator) -> torch.nn.Module:
    """Build without initialising, then fill from a pack or from the generator."""
    with torch.device("meta"):
        module = make()
    module = module.to_empty(device=device).eval()
    if pack is not None:
        return load_flax_params(module, pack)
    return seed_weights(module, generator)


def init_cascade(mode: str = "deepcad", weights_dir: Optional[str] = None, seed: int = 0,
                 batch_size: int = 16, dtype: torch.dtype = torch.float32, device: str = "cuda",
                 step_overrides: Optional[Dict] = None) -> Cascade:
    """The cascade for ``mode`` with weights from ``weights_dir`` (npz packs,
    at the architecture they hold) or seeded from ``seed`` at the production
    widths, on ``device``."""
    dev = resolve_device(device)
    arch = arch_of_packs(weights_dir) if weights_dir else "production"
    config = CascadeConfig.for_mode(mode, batch_size=batch_size, **(step_overrides or {}))
    gen = torch.Generator(device=dev).manual_seed(seed)
    pack = (lambda name: os.path.join(weights_dir, name)) if weights_dir else (lambda name: None)
    nets = {
        stage: _materialise(lambda s=stage: build_denoiser(s, config.use_cf, arch), dev,
                            pack(f"{stage}.npz"), gen)
        for stage in DENOISERS
    }
    surf_vae, edge_vae = (
        _materialise(lambda o=option: build_vae(o, arch), dev, pack(PACKS[option]), gen)
        for option in ("surface", "edge")
    )
    if dtype != torch.float32:
        for m in (*nets.values(), surf_vae, edge_vae):
            cast_compute(m, dtype)
    return Cascade(nets, surf_vae, edge_vae, config)


def sample_loop(cascade: Cascade, num_samples: int = 0, max_batches: int = 0, seed: int = 0,
                save_folder: Optional[str] = None, stage_times: Optional[Dict] = None,
                after_stage: Optional[Callable[[str], None]] = None) -> list:
    """Run batches until ``num_samples`` samples (0 = no limit) or
    ``max_batches`` batches (0 = no limit); returns the batches as numpy
    dicts and, with ``save_folder``, writes them to ``batches.npz`` there."""
    gen = torch.Generator(device=cascade.device).manual_seed(seed)
    noise = GeneratorNoise(gen)
    B = cascade.cfg.batch_size
    batches = []
    while True:
        out = cascade(noise, stage_times=stage_times, after_stage=after_stage)
        batches.append({k: v.cpu().numpy() for k, v in out.items()})
        if (num_samples and len(batches) * B >= num_samples) or (
                max_batches and len(batches) >= max_batches):
            break
    if save_folder:
        os.makedirs(save_folder, exist_ok=True)
        np.savez_compressed(
            os.path.join(save_folder, "batches.npz"),
            **{f"{k}__{bi}": v for bi, b in enumerate(batches) for k, v in b.items()},
        )
    return batches


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--mode", choices=["abc", "deepcad", "furniture"], default="deepcad")
    p.add_argument("--weights_dir", default=None,
                   help="folder of npz packs; random production-width weights from --seed "
                        "when absent")
    p.add_argument("--num_samples", type=int, default=0, help="stop after N samples (0 = no limit)")
    p.add_argument("--max_batches", type=int, default=0)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--pndm_steps", type=int, default=None)
    p.add_argument("--pos_pndm_calls", type=int, default=None)
    p.add_argument("--ddpm_tail", type=int, default=None)
    p.add_argument("--fast_steps", type=int, default=None,
                   help="N-step DDIM per stage instead of the full protocol")
    p.add_argument("--save_folder", default=None, help="default: samples_<mode>")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if not (args.num_samples or args.max_batches):
        p.error("give --num_samples or --max_batches")

    overrides = {k: getattr(args, k)
                 for k in ("pndm_steps", "pos_pndm_calls", "ddpm_tail", "fast_steps")
                 if getattr(args, k) is not None}
    cascade = init_cascade(args.mode, args.weights_dir, args.seed, args.batch_size,
                           torch.bfloat16 if args.bf16 else torch.float32, args.device,
                           overrides)
    stage_times: Dict[str, float] = {}
    t0 = time.perf_counter()
    batches = sample_loop(cascade, args.num_samples, args.max_batches, args.seed,
                          args.save_folder or f"samples_{args.mode}", stage_times)
    print(f"generated {len(batches)} batches of {args.batch_size} in "
          f"{time.perf_counter() - t0:.2f} s; per stage "
          + ", ".join(f"{k} {v:.2f} s" for k, v in stage_times.items()))


if __name__ == "__main__":
    main()
