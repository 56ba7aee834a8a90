"""Time the generation cascade at production sizes (seeded weights, bf16) on
the card, with seconds per stage; or one stage alone.

Port of ``scripts/bench_cascade.py``. Usage::

    python -m brepgen_tpu_torch.tools.bench_cascade [mode] [attn_impl] [aot_cache]
        [stage] [reps] [--device cpu] [--small]

``mode`` is a sampling preset (deepcad by default); ``attn_impl`` is the
attention of all four denoisers, ``kernel`` (the CUDA kernels, by length)
or ``plain``; ``aot_cache`` is the folder of the stage graphs' manifest
(``graphs.json``; "" for none). On the card every denoiser call replays a
CUDA graph of its stage (``sampling/aot.py``), captured at its first call,
so the first batch includes the captures and the second is the steady one;
``stage_s`` is the steady batch's seconds per stage (``Cascade.__call__``'s
``stage_times``, which synchronises around each stage).

Per-stage forms: ``stage`` = ``edgez`` runs that stage once on zero inputs
(``Cascade.precompile_stage``: it captures the stage's graphs); ``stage`` =
``time:edgez@24`` times ``reps`` (default 2) runs of the stage on random
inputs (``Cascade.run_stage_random``) on a compacted bucket of 24 face slots
(``@K`` optional).

``BREPGEN_BENCH_BATCH`` sets the batch (default 16). ``BREPGEN_BENCH_COMPACT=K``
times the compacted cascade with the edge stages forced onto a K-face bucket:
seeded weights dedup nothing, so the bucket is forced through
``compact_granularity=K`` and a bbox threshold of 100 (every sample keeps
one face, so the bucket is exactly K); the work does not depend on the mask
at fixed shapes, so this is the time of a production run whose dedup keeps at
most K of the face slots.

The JAX script draws a fresh seed per process because its remote TPU backend
cached results of repeated calls; a CUDA card does not, so the seed is
``SEED`` (the steady batch takes SEED + 1). It also printed
``projected_3k_run_v5e8_hours``, a projection onto a TPU pod of 8 chips,
which has no counterpart here. The card's name and power limit go to stderr
beside the JSON.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import torch

from brepgen_tpu_torch import card, card_line, resolve_device

SEED = 0  # of the weights and the first batch's noise


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("mode", nargs="?", default="deepcad")
    p.add_argument("attn_impl", nargs="?", default="kernel", choices=("kernel", "plain"))
    p.add_argument("aot_cache", nargs="?", default="")
    p.add_argument("stage", nargs="?", default=None)
    p.add_argument("reps", nargs="?", type=int, default=2)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--small", action="store_true", help="the tiny debug architecture")
    return p.parse_args(argv)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    from brepgen_tpu_torch.cli.sample_main import load_models
    from brepgen_tpu_torch.sampling import Cascade, CascadeConfig, GeneratorNoise
    from brepgen_tpu_torch.sampling.aot import stage_graphs

    print(card_line(card(dev)), file=sys.stderr, flush=True)
    bench_bs = int(os.environ.get("BREPGEN_BENCH_BATCH", 16))
    cfg = CascadeConfig.for_mode(args.mode, batch_size=bench_bs)
    force_bucket = int(os.environ.get("BREPGEN_BENCH_COMPACT", "0"))
    if force_bucket:
        cfg = dataclasses.replace(cfg, compact=True, compact_granularity=force_bucket,
                                  bbox_threshold=100.0)
    models = load_models(cfg.use_cf, seed=SEED, dtype=torch.bfloat16, device=dev,
                         small=args.small, attn_impl=args.attn_impl)
    cascade = Cascade(*models, cfg, graphs=stage_graphs(dev, args.aot_cache or None))

    if args.stage is not None:
        if args.stage.startswith("time:"):
            name, _, bucket = args.stage.split(":", 1)[1].partition("@")
            ns_c = int(bucket) if bucket else None
            times = []
            for i in range(args.reps):
                _sync(dev)
                t0 = time.perf_counter()
                cascade.run_stage_random(name, SEED + i, ns_c=ns_c)
                _sync(dev)
                times.append(time.perf_counter() - t0)
                print(f"{name} run {i}: {times[-1]:.2f}s", file=sys.stderr, flush=True)
            report = {"stage": name, "mode": args.mode, "attn": args.attn_impl, "ns_c": ns_c,
                      "times_s": times}
            print(json.dumps(report), flush=True)
            return report
        t0 = time.perf_counter()
        cascade.precompile_stage(args.stage)
        seconds = time.perf_counter() - t0
        print(f"precompiled {args.stage} in {seconds:.1f}s", flush=True)
        return {"precompiled": args.stage, "seconds": seconds}

    noise = lambda seed: GeneratorNoise(torch.Generator(device=dev).manual_seed(seed))  # noqa
    print(f"run seed: {SEED}", file=sys.stderr, flush=True)
    _sync(dev)
    t0 = time.perf_counter()
    cascade(noise(SEED))
    _sync(dev)
    t_first = time.perf_counter() - t0
    print(f"first call (captures + run): {t_first:.1f}s", file=sys.stderr, flush=True)

    stage_times = {}
    t0 = time.perf_counter()
    cascade(noise(SEED + 1), stage_times=stage_times)
    _sync(dev)
    t_run = time.perf_counter() - t0
    report = {
        "mode": args.mode,
        "attn": args.attn_impl,
        "forced_compact_bucket": force_bucket or None,
        "batch_size": cfg.batch_size,
        "first_call_s": t_first,
        f"steady_s_per_batch{cfg.batch_size}": t_run,
        "breps_per_min_chip": cfg.batch_size / t_run * 60,
        "stage_s": stage_times,
        "projected_3k_run_chip_hours": 3000 / cfg.batch_size * t_run / 3600,
    }
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
