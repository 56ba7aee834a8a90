"""The reference sampler's duplicate-box removal: boxes rounded to 4
decimals; box i is dropped when an earlier kept box lies within the
threshold in every coordinate (max corner deviation), in either corner
order. Slot 0 is always kept. Faces: over each sample's face boxes; edges:
over each face's edge boxes, and every edge of a dropped face is dropped."""

from __future__ import annotations

import torch


def keep_boxes(boxes: torch.Tensor, threshold: float) -> torch.Tensor:
    """[..., S, 6] -> keep [..., S]."""
    b = (torch.round(boxes.float() * 1e4) / 1e4).reshape(*boxes.shape[:-1], 2, 3)
    S = boxes.shape[-2]
    keep = torch.zeros(boxes.shape[:-1], dtype=torch.bool, device=boxes.device)
    keep[..., 0] = True
    for i in range(1, S):
        bi = b[..., i:i + 1, :, :]
        prev = b[..., :i, :, :]
        same = (prev - bi).abs().amax(dim=(-1, -2)) < threshold
        swapped = (prev - bi.flip(-2)).abs().amax(dim=(-1, -2)) < threshold
        keep[..., i] = ~((same | swapped) & keep[..., :i]).any(dim=-1)
    return keep


def keep_edges(edge_boxes: torch.Tensor, face_keep: torch.Tensor,
               threshold: float) -> torch.Tensor:
    """[B, nf, ne, 6], [B, nf] -> edge keep [B, nf, ne]."""
    return keep_boxes(edge_boxes, threshold) & face_keep[..., None]
