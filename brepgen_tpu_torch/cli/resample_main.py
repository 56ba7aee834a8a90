"""Re-sample committed packs and report validity per setting:
``python -m brepgen_tpu_torch.cli.resample_main --weights_dir PACKS --out OUT``.

Port of ``scripts/resample_demo.py``, which produced BASELINE.md's quality
rows: the cascade at the size the demo packs were trained at (``--max_face
10 --max_edge 8``, batch 16, the full PNDM + DDPM protocol) samples
``--sample_batches`` batches once, and each ``--z_thresholds`` value
post-processes them (``sample_main.process_one``, with the recovery ladder
under ``--recover``) into ``OUT/z<thr>/`` as STEP + STL, printing one JSON
line per setting with the reference's keys. ``--dump`` keeps the raw batches
in ``OUT/batches.npz``; ``--from_dump`` post-processes such a dump instead
of sampling, so strict and recovered validity come from the same samples.
``--cf`` samples class-conditional packs per class and guidance weight.

Differences from the reference: the widths come from the packs
(``cli/build.py:arch_of_packs``) and the class count from
``classes_of_pack``; ``--bf16`` picks the compute type, where the reference
took bf16 on any accelerator; on the card each stage replays a CUDA graph
(``sampling/aot.py``) and ``--aot_cache DIR`` receives the graphs'
manifest; each batch's noise comes from a ``torch.Generator`` seeded with
the reference's seed (``--seed``, 5000, + batch; under
``--cf`` 5000 + 100 class + 1000 int(10 w) + batch), and since torch cannot
replay JAX's PRNG the draws differ from the reference's: compare the
distributions, not the samples. Samples are post-processed in a pool of
threads, as the sample CLI does, and tallied in sample order.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

from brepgen_tpu_torch import resolve_device
from brepgen_tpu_torch.cli.sample_main import SampleRun, load_models, process_one
from brepgen_tpu_torch.postprocess.pipeline import make_padded_decoder
from brepgen_tpu_torch.sampling import Cascade, CascadeConfig, GeneratorNoise
from brepgen_tpu_torch.sampling.aot import stage_graphs

BATCH = 16
SEED = 5000
WORKERS = 8  # postprocess threads, the sample CLI's default
CLASS_NAMES = {0: "uncond", 1: "cuboid", 2: "prism", 3: "cylinder"}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--weights_dir", required=True,
                   help="folder of npz packs, e.g. artifacts/demo_round5/all160k/ckpt_packed")
    p.add_argument("--out", required=True)
    p.add_argument("--max_face", type=int, default=10)
    p.add_argument("--max_edge", type=int, default=8)
    p.add_argument("--sample_batches", type=int, default=4)
    p.add_argument("--z_thresholds", type=float, nargs="+", default=[0.1, 0.2, 0.3, 0.5])
    p.add_argument("--recover", action="store_true",
                   help="enable the edge-pairing recovery ladder; reports strict and recovered "
                        "validity separately")
    p.add_argument("--dump", action="store_true",
                   help="save the raw cascade batches to OUT/batches.npz (under --cf "
                        "OUT/w<w>/<class>/batches.npz) for a later --from_dump")
    p.add_argument("--from_dump", default=None,
                   help="skip sampling: post-process the batches of a batches.npz written by "
                        "--dump (or the sample CLI)")
    p.add_argument("--cf", action="store_true",
                   help="class-conditional packs: sample per class with CFG")
    p.add_argument("--classes", type=int, nargs="+", default=[1, 2, 3],
                   help="class ids under --cf (1=cuboid 2=prism 3=cylinder; 0=uncond)")
    p.add_argument("--cfg_weights", type=float, nargs="+", default=[0.6],
                   help="guidance weights under --cf (reference w=0.6)")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--seed", type=int, default=SEED,
                   help=f"base of the batches' seeds (the reference's {SEED}); another value "
                        "draws another set of samples")
    p.add_argument("--aot_cache", default=None,
                   help="DIR for the graphs.json manifest of the stages' CUDA graphs (on the "
                        "card each stage's denoiser call replays one; needs a CUDA card)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def load_dump(path: str) -> List[Dict[str, np.ndarray]]:
    """The batches of a ``batches.npz`` of ``{key}__{batch}`` arrays."""
    with np.load(path) as raw:
        n = 1 + max(int(k.rsplit("__", 1)[1]) for k in raw.files)
        return [{k.rsplit("__", 1)[0]: raw[k] for k in raw.files if k.endswith(f"__{b}")}
                for b in range(n)]


def generate(cascade: Cascade, batches: int, seed: int,
             dump_path: Optional[str] = None) -> List[Dict[str, np.ndarray]]:
    """``batches`` batches, batch ``b`` drawn from a generator seeded with
    ``seed + b``; the stage seconds are printed, the batches kept in
    ``dump_path`` when given."""
    out, stage_times = [], {}
    t0 = time.perf_counter()
    for b in range(batches):
        noise = GeneratorNoise(torch.Generator(device=cascade.device).manual_seed(seed + b))
        out.append({k: v.cpu().numpy() for k, v in cascade(noise, stage_times).items()})
    # the card's reserved memory: a --cf run keeps every class's graphs
    held = ""
    if cascade.device.type == "cuda":
        gib = torch.cuda.memory_reserved(cascade.device) / 2**30
        held = f"; card memory reserved {gib:.3f} GiB"
    print(f"sampled {batches} batches of {cascade.cfg.batch_size} in "
          f"{time.perf_counter() - t0:.2f} s; cascade seconds per stage: "
          + ", ".join(f"{k} {v:.2f}" for k, v in stage_times.items()) + held, flush=True)
    if dump_path:
        os.makedirs(os.path.dirname(dump_path), exist_ok=True)
        np.savez_compressed(dump_path, **{f"{k}__{b}": v for b, batch in enumerate(out)
                                          for k, v in batch.items()})
    return out


def postprocess(batches: List[Dict[str, np.ndarray]], z_thr: float, save_dir: str,
                decoders, recover: bool, device: torch.device, extra: Dict) -> Dict:
    """Every sample of ``batches`` through ``process_one`` into
    ``save_dir``; returns (and prints as one JSON line) the tallies under
    the reference's keys."""
    os.makedirs(save_dir, exist_ok=True)
    jobs = [(batch, b) for batch in batches for b in range(batch["surf_mask"].shape[0])]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(WORKERS) as pool:
        results = list(pool.map(
            lambda job: process_one(*job, *decoders, z_thr, save_dir, recover, device), jobs))
    seconds = time.perf_counter() - t0
    run = SampleRun(batches=batches, attempted=len(jobs))
    for result in results:
        run.add(*result)
    errors = [note[:240] for name, note in results if name is None][:20]
    faces = [int(c) for batch in batches for c in (~batch["surf_mask"]).sum(1)]
    n, valid, strict, solid = run.attempted, run.produced, run.strict, run.solid
    line = {
        **extra,
        "z_threshold": z_thr,
        "attempted": n,
        "valid_breps": valid,
        "valid_strict": strict,
        "valid_solid": solid,
        "recovered": run.rungs,
        "validity": round(valid / n, 3),
        "validity_strict": round(strict / n, 3),
        "validity_solid": round(solid / n, 3),
        "dedup_face_counts": faces[:64],
        "failures": run.failures,
        "error_samples": errors,
        "postprocess_s": round(seconds, 1),
    }
    print(json.dumps(line), flush=True)
    return line


def run(args: argparse.Namespace, batch_size: int = BATCH,
        step_overrides: Optional[Dict] = None) -> List[Dict]:
    """The command line's work; returns the JSON lines. ``batch_size`` and
    ``step_overrides`` (``CascadeConfig`` fields) let a test shrink it."""
    device = resolve_device(args.device)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    nets, surf_vae, edge_vae = load_models(args.cf, args.weights_dir, dtype=dtype,
                                           device=args.device)
    decoders = (make_padded_decoder(surf_vae.decode, (4, 4, 3), device),
                make_padded_decoder(edge_vae.decode, (4, 3), device))
    graphs = None if args.from_dump else stage_graphs(device, args.aot_cache)

    def cascade(**kw) -> Cascade:
        cfg = CascadeConfig(batch_size=batch_size, num_surfaces=args.max_face,
                            num_edges=args.max_edge, **kw, **(step_overrides or {}))
        return Cascade(nets, surf_vae, edge_vae, cfg, graphs=graphs)

    lines = []
    if args.cf:
        # per (guidance weight, class): conditioning fidelity and the guidance
        # sweep (reference sample.py:132-134)
        for w in args.cfg_weights:
            for cls in args.classes:
                folder = os.path.join(args.out, f"w{w:g}", CLASS_NAMES[cls])
                batches = generate(
                    cascade(use_cf=True, class_label=cls, cfg_weight=w), args.sample_batches,
                    args.seed + 100 * cls + int(w * 10) * 1000,
                    os.path.join(folder, "batches.npz") if args.dump else None)
                for z_thr in args.z_thresholds:
                    lines.append(postprocess(batches, z_thr, folder, decoders, args.recover,
                                             device, {"class": CLASS_NAMES[cls],
                                                      "cfg_weight": w}))
        return lines
    if args.from_dump:
        batches = load_dump(args.from_dump)
    else:
        batches = generate(cascade(), args.sample_batches, args.seed,
                           os.path.join(args.out, "batches.npz") if args.dump else None)
    for z_thr in args.z_thresholds:
        lines.append(postprocess(batches, z_thr, os.path.join(args.out, f"z{z_thr}"),
                                 decoders, args.recover, device, {}))
    return lines


def main(argv=None) -> List[Dict]:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
