"""Duplicate-bbox detection with static shapes.

Port of ``brepgen_tpu/sampling/dedup.py``: the greedy first-occurrence scan
of the reference sampler. A bbox (rounded to 4 decimals) duplicates an
already-kept one when its max corner deviation, in either corner order, is
below the threshold. Tokens stay in place and a keep mask is returned; slot
0 is always kept.
"""

from __future__ import annotations

import torch


def _round4(x: torch.Tensor) -> torch.Tensor:
    return torch.round(x * 1e4) / 1e4


def dedup_bboxes(bboxes: torch.Tensor, threshold: float) -> torch.Tensor:
    """bboxes [..., S, 6] -> keep mask [..., S] (True = keep), vectorised
    over the leading dims."""
    S = bboxes.shape[-2]
    b = _round4(bboxes).reshape(*bboxes.shape[:-1], 2, 3)
    b_rev = b.flip(-2)
    # pairwise max-abs corner deviation, both orientations: [..., S, S]
    diff = (b[..., :, None, :, :] - b[..., None, :, :, :]).abs().amax(dim=(-1, -2))
    diff_rev = (b[..., :, None, :, :] - b_rev[..., None, :, :, :]).abs().amax(dim=(-1, -2))
    near = (diff < threshold) | (diff_rev < threshold)  # near[..., i, j]

    keep = torch.zeros(bboxes.shape[:-1], dtype=torch.bool, device=bboxes.device)
    keep[..., 0] = True
    for i in range(1, S):
        keep[..., i] = ~(near[..., i, :i] & keep[..., :i]).any(dim=-1)
    return keep


def dedup_edges_per_face(edge_bboxes: torch.Tensor, surf_keep: torch.Tensor,
                         threshold: float) -> torch.Tensor:
    """[B, nf, ne, 6] + face keep [B, nf] -> edge keep [B, nf, ne]; edges of
    dropped faces are all masked, the first edge slot of a kept face is kept."""
    return dedup_bboxes(edge_bboxes, threshold) & surf_keep[:, :, None]
