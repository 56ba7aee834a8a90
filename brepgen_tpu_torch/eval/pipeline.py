"""Evaluation drivers: STL -> PLY point clouds, and the JSD/MMD/COV protocol.

Port of ``brepgen_tpu/eval/pipeline.py`` (parity with reference
``sample_points.py``: 2000 surface-sampled points per STL, written as PLY;
and ``pc_metric.py:main``: 10 repeats of 1000 refs vs 3x1000 samples;
per-run and averaged metrics written to ``{fake}_results.txt``). The calls
to ``random`` come in the same order, so one seed selects the same clouds
as the JAX package. The Chamfer matrix of each repeat is one launch of
kernel K4 on the card.
"""

from __future__ import annotations

import multiprocessing
import os
import random
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

from brepgen_tpu_torch.eval.metrics import (
    compute_cov_mmd,
    jsd_between_point_cloud_sets,
    normalize_pc,
)
from brepgen_tpu_torch.geometry.ply import read_ply, write_ply
from brepgen_tpu_torch.geometry.sampling import sample_surface
from brepgen_tpu_torch.geometry.stl import read_stl

N_POINTS = 2000


def find_files(root: str, suffix: str) -> List[str]:
    out = []
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            if f.endswith(suffix):
                out.append(os.path.join(dirpath, f))
    return sorted(out)


def _sample_one(args):
    path, out_dir, seed = args
    tris = read_stl(path)
    pts = sample_surface(tris, N_POINTS, np.random.default_rng(seed))
    name = os.path.splitext(os.path.basename(path))[0]
    write_ply(os.path.join(out_dir, name + ".ply"), pts)


def sample_points_dir(in_dir: str, out_dir: str, workers: int = 0, seed: int = 0) -> int:
    """Every .stl under in_dir -> 2000-point .ply in out_dir."""
    os.makedirs(out_dir, exist_ok=True)
    paths = find_files(in_dir, ".stl")
    jobs = [(p, out_dir, seed + i) for i, p in enumerate(paths)]
    if workers > 0:
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(workers, mp_context=ctx) as pool:
            list(pool.map(_sample_one, jobs))
    else:
        for j in jobs:
            _sample_one(j)
    return len(paths)


def _load_clouds(folder: str) -> np.ndarray:
    clouds = []
    for p in find_files(folder, ".ply"):
        pc = read_ply(p)
        if len(pc) > N_POINTS:
            idx = random.sample(range(len(pc)), N_POINTS)
            pc = pc[idx]
        clouds.append(normalize_pc(pc))
    return np.stack(clouds)


def run_metrics(
    fake_dir: str,
    real_dir: str,
    n_test: int = 1000,
    multi: int = 3,
    times: int = 10,
    seed: Optional[int] = None,
    output: Optional[str] = None,
    device: str | torch.device = "cuda",
) -> Dict[str, float]:
    if seed is not None:
        random.seed(seed)
    sample_pcs = _load_clouds(fake_dir)
    ref_pcs = _load_clouds(real_dir)

    output = output or (fake_dir.rstrip("/") + "_results.txt")
    results = []
    with open(output, "w") as fp:
        for i in range(times):
            s_idx = random.sample(range(len(sample_pcs)), min(multi * n_test, len(sample_pcs)))
            r_idx = random.sample(range(len(ref_pcs)), min(n_test, len(ref_pcs)))
            s = sample_pcs[s_idx]
            r = ref_pcs[r_idx]
            res = compute_cov_mmd(s, r, device)
            res["JSD"] = jsd_between_point_cloud_sets(s, r)
            print(res, file=fp)
            results.append(res)
        avg = {f"avg-{k}": float(np.mean([x[k] for x in results])) for k in results[0]}
        print(avg, file=fp)
    return avg
