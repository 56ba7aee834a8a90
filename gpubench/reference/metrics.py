"""The point-cloud protocol of BrepGen's ``pc_metric.py``: Chamfer distance
(mean squared nearest-neighbour distance in both directions, summed),
MMD-CD (over references, the least distance from any sample, averaged),
COV-CD (the share of references that are some sample's nearest) and JSD of
the 28^3 occupancy counts of the two sets."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from gpubench.reference.precision import q

SLAB_ELEMENTS = 1 << 27  # distances held at once


def chamfer_rows(x: torch.Tensor, y: torch.Tensor, prec: str = "f32") -> torch.Tensor:
    """[S, P, 3] x [R, P, 3] -> [S, R] Chamfer distances. ``f32``: direct
    differences ((dx^2 + dy^2) + dz^2); ``tf32``: the |a|^2 + |b|^2 - 2 a.b
    form with its product in TF32 (the control)."""
    S, P, _ = x.shape
    R = y.shape[0]
    out = torch.empty((S, R), dtype=torch.float32, device=x.device)
    per = max(1, SLAB_ELEMENTS // (P * P))
    for i in range(S):
        xi = x[i].float()
        for j in range(0, R, per):
            yj = y[j:j + per].float()
            if prec == "tf32":
                d2 = ((xi * xi).sum(-1)[None, :, None] + (yj * yj).sum(-1)[:, None, :]
                      - 2.0 * torch.matmul(q(xi, prec)[None], q(yj, prec).transpose(1, 2)))
            else:
                d2 = None
                for c in range(3):
                    diff = xi[None, :, None, c] - yj[:, None, :, c]
                    d2 = diff * diff if d2 is None else d2 + diff * diff
            out[i, j:j + per] = d2.amin(dim=2).mean(dim=1) + d2.amin(dim=1).mean(dim=1)
    return out


def cov_mmd(d: np.ndarray, prec: str = "f64") -> Dict[str, float]:
    """MMD-CD and COV-CD of a [samples, references] Chamfer matrix, reduced
    in float64, or in bfloat16 (the control)."""
    if prec == "bf16":
        t = torch.as_tensor(np.asarray(d, dtype=np.float32)).to(torch.bfloat16)
        mins = t.min(dim=0).values
        return {"MMD-CD": float(mins.sum(dtype=torch.bfloat16) / mins.numel()),
                "COV-CD": len(torch.unique(t.argmin(dim=1))) / d.shape[1]}
    d = np.asarray(d, dtype=np.float64)
    return {"MMD-CD": float(d.min(axis=0).mean()),
            "COV-CD": len(np.unique(d.argmin(axis=1))) / d.shape[1]}


def occupancy(clouds: np.ndarray, resolution: int = 28) -> np.ndarray:
    """Points per cell of the regular [-1, 1]^3 lattice, summed over clouds."""
    spacing = 2.0 / (resolution - 1)
    idx = np.clip(np.round((clouds.reshape(-1, 3) + 1.0) / spacing), 0, resolution - 1)
    idx = idx.astype(np.int64)
    flat = (idx[:, 0] * resolution + idx[:, 1]) * resolution + idx[:, 2]
    return np.bincount(flat, minlength=resolution ** 3).astype(np.float64)


def jsd(a: np.ndarray, b: np.ndarray, resolution: int = 28) -> float:
    P, Q = occupancy(a, resolution), occupancy(b, resolution)
    P, Q = P / P.sum(), Q / Q.sum()
    M = 0.5 * (P + Q)

    def kl(u, v):
        m = (u > 0) & (v > 0)
        return float(np.sum(u[m] * np.log2(u[m] / v[m])))

    return 0.5 * (kl(P, M) + kl(Q, M))
