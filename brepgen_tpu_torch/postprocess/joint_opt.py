"""Joint optimization of faces/edges/vertices against recovered topology.

Port of ``brepgen_tpu/postprocess/joint_opt.py`` (reference ``joint_optimize``,
``utils.py:672-776``):

  1. edges (analytic, numpy, unchanged): scale each decoded edge so its
     endpoint span matches the merged vertex span, orient it (flip if
     reversed), offset by the mean endpoint residual, then blend an
     endpoint-snap correction linearly along the curve;
  2. faces: initialize world-space grids from surf_ncs x bbox (growing the
     bbox by 1.05x if it does not cover its wire), then run 200 AdamW
     steps on a per-face translation offset minimizing the one-directional
     Chamfer distance from each face's boundary edge points to the face
     grid. The JAX package runs this as plain XLA on its default backend;
     here it is an eager torch loop on ``device`` (the card by default),
     batched over faces with an edge-count mask.

Inputs are in un-scaled world coords (bboxes already divided by 3).
Returns (surf_wcs [F,32,32,3], edge_wcs [E,32,3]).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from brepgen_tpu_torch.data.augment import compute_bbox_center_and_size, get_bbox_minmax

OPT_ITERS = 200


def _optimize_surface_offsets(
    surf_init: np.ndarray,     # [F, 32, 32, 3]
    edge_pts: np.ndarray,      # [F, Emax*32, 3] padded boundary points
    edge_valid: np.ndarray,    # [F, Emax*32] 1.0 = real point
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """200 AdamW iters on per-face offsets; loss = sum over valid edge
    points of squared distance to nearest surface point, averaged over
    faces (the JAX ``loss_fn``: expansion form |e|^2 + |s|^2 - 2 e.s, min
    over surface points, masked sum / F)."""
    F = len(surf_init)
    surf = torch.as_tensor(surf_init.reshape(F, -1, 3), dtype=torch.float32, device=device)
    epts = torch.as_tensor(edge_pts, dtype=torch.float32, device=device)
    w = torch.as_tensor(edge_valid, dtype=torch.float32, device=device)
    e2 = torch.sum(epts ** 2, -1)[:, :, None]  # constant across steps

    offsets = torch.zeros((F, 3), dtype=torch.float32, device=device, requires_grad=True)
    opt = torch.optim.AdamW([offsets], lr=1e-3, betas=(0.95, 0.999), eps=1e-8,
                            weight_decay=1e-6)
    with torch.enable_grad():
        for _ in range(OPT_ITERS):
            moved = surf + offsets[:, None, :]
            d2 = (e2 + torch.sum(moved ** 2, -1)[:, None, :]
                  - 2.0 * torch.einsum("fed,fsd->fes", epts, moved))
            # amin spreads the gradient over ties, as jnp.min does
            loss = torch.sum(torch.amin(d2, dim=-1) * w) / F
            opt.zero_grad(set_to_none=False)
            loss.backward()
            opt.step()
    return offsets.detach().cpu().numpy()


def joint_optimize(
    surf_ncs: np.ndarray,        # [F, 32, 32, 3]
    edge_ncs: np.ndarray,        # [E, 32, 3]
    surfPos: np.ndarray,         # [F, 6] un-scaled bboxes
    unique_vertices: np.ndarray, # [V, 3]
    EdgeVertexAdj: np.ndarray,   # [E, 2]
    FaceEdgeAdj: List[List[int]],
    num_edge: int,
    num_surf: int,
    device: str | torch.device = "cuda",
):
    # --- edges: analytic scale / flip / offset -------------------------
    edge_ncs_se = edge_ncs[:, [0, -1]]
    edge_vertex_se = unique_vertices[EdgeVertexAdj]  # [E, 2, 3]

    edge_wcs = []
    for wcs, ncs_se, vertex_se in zip(edge_ncs, edge_ncs_se, edge_vertex_se):
        scale_target = np.linalg.norm(vertex_se[0] - vertex_se[1])
        scale_ncs = np.linalg.norm(ncs_se[0] - ncs_se[1])
        edge_scale = scale_target / max(scale_ncs, 1e-12)

        edge_updated = wcs * edge_scale
        edge_se = ncs_se * edge_scale

        offset = vertex_se - edge_se
        offset_rev = vertex_se - edge_se[::-1]
        if np.abs(offset_rev[0] - offset_rev[1]).mean() < np.abs(offset[0] - offset[1]).mean():
            edge_updated = edge_updated[::-1]
            offset = offset_rev
        edge_wcs.append(edge_updated + offset.mean(0)[None])
    edge_wcs = np.stack(edge_wcs)

    # endpoint snap with linear blend along the curve
    for i in range(len(edge_wcs)):
        start_vec = edge_vertex_se[i, 0] - edge_wcs[i, 0]
        end_vec = edge_vertex_se[i, 1] - edge_wcs[i, -1]
        weight = (np.arange(32) / 31)[:, None]
        edge_wcs[i] += start_vec[None] * (1 - weight) + end_vec[None] * weight

    # --- faces: init from bbox, then offset optimization ---------------
    face_edge_pts = [edge_wcs[adj].reshape(-1, 3) for adj in FaceEdgeAdj]

    surf_wcs_init = []
    for pts, ncs, bbox in zip(face_edge_pts, surf_ncs, surfPos):
        surf_center, surf_scale = compute_bbox_center_and_size(bbox[0:3], bbox[3:])
        mn, mx = get_bbox_minmax(pts)
        _, edge_scale = compute_bbox_center_and_size(mn, mx)
        if surf_scale < edge_scale:
            surf_scale = 1.05 * edge_scale
        surf_wcs_init.append(ncs * (surf_scale / 2) + surf_center)
    surf_wcs_init = np.stack(surf_wcs_init)

    e_max = max(len(p) for p in face_edge_pts)
    epts = np.zeros((num_surf, e_max, 3), np.float32)
    evalid = np.zeros((num_surf, e_max), np.float32)
    for i, p in enumerate(face_edge_pts):
        epts[i, : len(p)] = p
        evalid[i, : len(p)] = 1.0

    offsets = _optimize_surface_offsets(surf_wcs_init, epts, evalid, device)
    surf_wcs = surf_wcs_init + offsets[:, None, None, :]

    return surf_wcs, edge_wcs
