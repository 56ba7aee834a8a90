"""Score sampled solids against held-out synthetic solids:
``python -m brepgen_tpu_torch.cli.metrics_main --run RUN [--samples_dir STL_DIR]``.

Port of ``scripts/demo_metrics.py``, which turned a run into BASELINE.md's
quality row: 2000-point clouds from the run's STLs (``RUN/samples[/<cls>]``
or ``--samples_dir``, e.g. ``resample_main``'s ``OUT/z0.2``) against clouds
of held-out solids of the same family, drawn from ``--heldout_seed`` (777,
disjoint from the training set's seed 0), through the JSD / MMD-CD / COV-CD
protocol with one reference draw of all held-out clouds per repeat
(``run_metrics(n_test=n_real, multi=1, times=3, seed=0)``). The Chamfer
matrices go through kernel K4 on the card (``--device cuda``, the default).
Prints the averaged metrics as one JSON line; the per-repeat results go to a
text file beside the clouds.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
from typing import Dict, List, Optional

import numpy as np

from brepgen_tpu_torch.data.synthetic import make_cuboid, make_cylinder, make_dataset, make_prism
from brepgen_tpu_torch.eval.pipeline import N_POINTS, run_metrics, sample_points_dir
from brepgen_tpu_torch.geometry.ply import write_ply
from brepgen_tpu_torch.geometry.sampling import sample_surface

KINDS = ("cuboid", "prism", "cylinder")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--run", required=True, help="run folder: held-out clouds and results go here")
    p.add_argument("--family", default="all", choices=["all", "cuboid", "heldout"])
    p.add_argument("--heldout", type=int, default=64)
    p.add_argument("--heldout_seed", type=int, default=777,
                   help="disjoint from the demo trainer's dataset seed 0")
    p.add_argument("--times", type=int, default=3)
    p.add_argument("--cls", default=None, choices=KINDS,
                   help="class-conditional run: score samples/<cls> against held-out solids "
                        "of that kind only")
    p.add_argument("--vs", default=None, choices=KINDS,
                   help="score the --cls samples against held-out solids of another kind")
    p.add_argument("--samples_dir", default=None,
                   help="STL folder (overrides RUN/samples[/<cls>])")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def grid_triangles(grid: np.ndarray) -> np.ndarray:
    """[32, 32, 3] UV grid -> [2*31*31, 3, 3] triangles."""
    p00, p01, p10, p11 = grid[:-1, :-1], grid[:-1, 1:], grid[1:, :-1], grid[1:, 1:]
    t1 = np.stack([p00, p10, p11], axis=2)
    t2 = np.stack([p00, p11, p01], axis=2)
    return np.concatenate([t1, t2], axis=2).reshape(-1, 3, 3)


def heldout_solids(n: int, seed: int, family: str, kind: Optional[str]) -> List[Dict]:
    """``n`` held-out solids: one ``kind`` only (the parameter ranges of
    ``random_solid``), else the family's."""
    if kind is None and family != "cuboid":
        return make_dataset(n, seed=seed, family=family)
    rng = np.random.default_rng(seed)
    kind = kind or "cuboid"
    solids = []
    for i in range(n):
        if kind == "cuboid":
            solids.append(make_cuboid(*rng.uniform(0.4, 2.0, 3), uid=f"h{i}"))
        elif kind == "prism":
            solids.append(make_prism(int(rng.integers(3, 8)), rng.uniform(0.5, 1.5),
                                     rng.uniform(0.4, 2.0), uid=f"h{i}"))
        else:
            solids.append(make_cylinder(rng.uniform(0.5, 1.5), rng.uniform(0.4, 2.0),
                                        uid=f"h{i}"))
    return solids


def heldout_clouds(out_dir: str, n: int, seed: int, family: str = "all",
                   kind: Optional[str] = None) -> int:
    """2000-point clouds of the held-out solids as ``heldout_<i>.ply``,
    points drawn from ``seed + 1``; returns the count."""
    os.makedirs(out_dir, exist_ok=True)
    solids = heldout_solids(n, seed, family, kind)
    rng = np.random.default_rng(seed + 1)
    for i, d in enumerate(solids):
        tris = np.concatenate([grid_triangles(g) for g in d["surf_wcs"]])
        write_ply(os.path.join(out_dir, f"heldout_{i}.ply"), sample_surface(tris, N_POINTS, rng))
    return len(solids)


def main(argv=None) -> Dict:
    args = parse_args(argv)
    held_kind = args.vs or args.cls
    sub = args.cls or ""
    cross = args.vs and args.vs != args.cls
    tag = sub + (f"_vs_{args.vs}" if cross else "")
    if args.samples_dir:
        # clouds beside their STL source: each sample set its own cloud folder
        fake_ply = args.samples_dir.rstrip("/") + "_fake_ply"
        out_txt = args.samples_dir.rstrip("/") + f"_metrics{'_vs_' + args.vs if cross else ''}.txt"
    else:
        fake_ply = os.path.join(args.run, "fake_ply" + (f"_{sub}" if sub else ""))
        out_txt = os.path.join(args.run, f"metrics_results{'_' + tag if tag else ''}.txt")
    real_ply = os.path.join(args.run, "heldout_ply" + (f"_{held_kind}" if held_kind else ""))
    stl_dir = args.samples_dir or os.path.join(args.run, "samples", sub)
    if os.path.isdir(fake_ply):
        shutil.rmtree(fake_ply)  # never score a stale or mixed cloud set
    n_fake = sample_points_dir(stl_dir, fake_ply)
    n_real = heldout_clouds(real_ply, args.heldout, args.heldout_seed, args.family, held_kind)
    print(f"clouds: {n_fake} fake vs {n_real} held-out", flush=True)
    if n_fake == 0:
        print(json.dumps({"error": "no valid samples to score"}))
        sys.exit(1)
    avg = run_metrics(fake_ply, real_ply, n_test=n_real, multi=1, times=args.times, seed=0,
                      output=out_txt, device=args.device)
    avg["n_fake_clouds"] = n_fake
    avg["n_heldout"] = n_real
    if sub:
        avg["cls"] = sub
        avg["vs"] = held_kind
    print(json.dumps(avg), flush=True)
    return avg


if __name__ == "__main__":
    main()
