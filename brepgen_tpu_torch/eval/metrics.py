"""Generative-quality metrics: JSD, MMD-CD, COV-CD.

Port of ``brepgen_tpu/eval/metrics.py`` (protocol parity with reference
``pc_metric.py``):
  * point clouds of 2000 points, centered and scaled to the unit cube
    (``normalize_pc``, ``pc_metric.py:219-226``);
  * pairwise Chamfer = mean of squared nearest-neighbor distances in both
    directions (``distChamfer`` / CUDA kernel, ``pc_metric.py:32-42,70``),
    here through the port's CUDA kernel K4 (``kernels/chamfer.py``);
  * MMD-CD: mean over references of the min CD from any sample;
    COV-CD: fraction of references matched as some sample's nearest
    (``compute_cov_mmd``, ``pc_metric.py:83-95``);
  * JSD over 28^3 occupancy grids (``pc_metric.py:98-170``), numpy, copied
    unchanged: the occupancy grid uses the closed-form lattice index
    instead of a NearestNeighbors tree (the grid is regular, so nearest
    cell = rounding).

Each scorer is a span: ``brepgen.eval.chamfer`` (the matrix and its copy
back, with CUDA events on a card), ``brepgen.eval.cov_mmd`` and
``brepgen.eval.jsd``, with the set sizes ``n_s`` and ``n_r``
(``utils/profiling.py``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from brepgen_tpu_torch import resolve_device
from brepgen_tpu_torch.kernels.chamfer import chamfer_matrix
from brepgen_tpu_torch.utils import profiling


def normalize_pc(points: np.ndarray) -> np.ndarray:
    points = points - points.mean(0)
    return points / np.max(np.abs(points))


def pairwise_chamfer(sample_pcs, ref_pcs, device: str | torch.device = "cuda") -> np.ndarray:
    """Full [N_sample, N_ref] chamfer matrix (f32) on ``device``: through
    kernel K4 on the card, through its plain version on the CPU."""
    dev = resolve_device(device)
    with profiling.span("brepgen.eval.chamfer", device=True, n_s=len(sample_pcs),
                        n_r=len(ref_pcs)):
        sp = torch.as_tensor(np.asarray(sample_pcs, np.float32), device=dev).contiguous()
        rp = torch.as_tensor(np.asarray(ref_pcs, np.float32), device=dev).contiguous()
        return chamfer_matrix(sp, rp).cpu().numpy()


def cov_mmd_from_matrix(d: np.ndarray) -> Dict[str, float]:
    """MMD-CD and COV-CD of one [N_sample, N_ref] chamfer matrix."""
    with profiling.span("brepgen.eval.cov_mmd", n_s=d.shape[0], n_r=d.shape[1]):
        mmd = float(d.min(axis=0).mean())
        matched = np.argmin(d, axis=1)
        cov = float(len(np.unique(matched))) / d.shape[1]
        return {"MMD-CD": mmd, "COV-CD": cov}


def compute_cov_mmd(sample_pcs, ref_pcs, device: str | torch.device = "cuda") -> Dict[str, float]:
    return cov_mmd_from_matrix(pairwise_chamfer(sample_pcs, ref_pcs, device))


# ---------------------------------------------------------------------------
# JSD


def _occupancy_counts(pclouds: np.ndarray, resolution: int) -> np.ndarray:
    """Per-cell count of POINTS landing in the cell, summed over clouds.

    Parity: ``entropy_of_occupancy_grid``'s ``grid_counters`` return value
    (``pc_metric.py:112-148``) — every point increments its nearest grid
    cell, duplicates included — which is the variable the reference feeds to
    ``jensen_shannon_divergence`` (``pc_metric.py:98-108``).  (The reference
    also tracks a per-cloud Bernoulli activation count, but uses it only for
    the entropy value, which JSD never consumes.)  Nearest grid cell on the
    regular [-1,1] lattice is closed-form rounding; exact half-way ties
    (measure zero for real data) may differ from an NN tie-break.
    """
    spacing = 2.0 / (resolution - 1)
    grid_counters = np.zeros(resolution**3)
    for pc in pclouds:
        idx3 = np.clip(np.round((pc + 1.0) / spacing), 0, resolution - 1).astype(int)
        flat = idx3[:, 0] * resolution**2 + idx3[:, 1] * resolution + idx3[:, 2]
        np.add.at(grid_counters, flat, 1)
    return grid_counters


def _jsdiv(P: np.ndarray, Q: np.ndarray) -> float:
    P = P / P.sum()
    Q = Q / Q.sum()
    M = 0.5 * (P + Q)

    def kl(a, b):
        idx = (a > 0) & (b > 0)
        return float(np.sum(a[idx] * np.log2(a[idx] / b[idx])))

    return 0.5 * (kl(P, M) + kl(Q, M))


def jsd_between_point_cloud_sets(
    sample_pcs: np.ndarray, ref_pcs: np.ndarray, resolution: int = 28
) -> float:
    with profiling.span("brepgen.eval.jsd", n_s=len(sample_pcs), n_r=len(ref_pcs)):
        a = _occupancy_counts(sample_pcs, resolution)
        b = _occupancy_counts(ref_pcs, resolution)
        return _jsdiv(a, b)
