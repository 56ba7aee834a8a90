"""Per-sample tensor assembly for every training stage (pure functions).

The port's own numpy copy of ``brepgen_tpu/data/assembly.py``, with the same
draws per (sample, seed).

Each function mirrors one reference ``Dataset.__getitem__`` exactly
(``dataset.py:120-589``) but as a pure numpy function of (sample dict,
np RNG) so it is testable, multiprocessing-friendly, and independent of any
framework data-loader:

  * VAE stages: raw surface grids / edge grids (+50% triple-axis rotation).
  * surfpos: x3-scaled face bboxes, shuffled, pad_repeat (no mask).
  * surfz:   face bboxes + NCS grids, pad_zero + mask.
  * edgepos: per-face duplicated ("mating") edge bboxes, pad_repeat per
    face over the edge axis, faces pad_zero + mask.
  * edgez:   duplicated edge grids/bboxes/lexsorted endpoint pairs,
    pad_zero over both axes, [nf, ne] mask.

Also implements ``filter_data`` (reference ``dataset.py:22-81``): drop
solids exceeding max_face/max_edge or with near-duplicate face/edge bboxes
under the scaled threshold -- this shapes the training distribution and is
replicated exactly.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from brepgen_tpu_torch.data.augment import bbox_corners, get_bbox, random_rotate_grids, rotate_point_cloud
from brepgen_tpu_torch.data.pad import pad_repeat, pad_zero


# ---------------------------------------------------------------------------
# filtering


def _has_near_duplicates(bboxes: np.ndarray, threshold: float) -> bool:
    """Greedy first-occurrence scan identical to the reference's loop."""
    boxes = bboxes.reshape(len(bboxes), 2, 3)
    non_repeat = boxes[:1]
    for bbox in boxes:
        diff = np.max(np.max(np.abs(non_repeat - bbox), -1), -1)
        if (diff < threshold).sum() >= 1:
            continue
        non_repeat = np.concatenate([non_repeat, bbox[None]], 0)
    return len(non_repeat) != len(boxes)


def filter_sample(
    data: Dict, max_face: int, max_edge: int, bbox_scaled: float, threshold: float
) -> bool:
    """True if the sample should be KEPT."""
    faceEdge_adj = data["faceEdge_adj"]
    surf_bbox = data["surf_bbox_wcs"]
    edge_bbox = data["edge_bbox_wcs"]

    if len(surf_bbox) > max_face:
        return False
    for adj in faceEdge_adj:
        if len(adj) > max_edge:
            return False
        if len(edge_bbox[adj]) == 0:
            return False

    if _has_near_duplicates(surf_bbox * bbox_scaled, threshold):
        return False
    for adj in faceEdge_adj:
        if _has_near_duplicates(edge_bbox[adj] * bbox_scaled, threshold):
            return False
    return True


# ---------------------------------------------------------------------------
# VAE stages


def assemble_surf_uv(data: Dict, rng: np.random.Generator, aug: bool = False) -> np.ndarray:
    """All face NCS grids of a sample, [nf, 32, 32, 3] (training flattens
    across samples; the reference trains on deduplicated individual grids)."""
    surf_uv = data["surf_ncs"]
    if aug and rng.random() > 0.5:
        out = []
        for grid in surf_uv:
            g = grid.reshape(-1, 3)
            for axis in ("x", "y", "z"):
                angle = rng.choice([90, 180, 270])
                g = rotate_point_cloud(g, angle, axis)
            out.append(g.reshape(32, 32, 3))
        surf_uv = np.stack(out)
    return surf_uv.astype(np.float32)


def assemble_edge_u(data: Dict, rng: np.random.Generator, aug: bool = False) -> np.ndarray:
    edge_u = data["edge_ncs"]
    if aug and rng.random() > 0.5:
        out = []
        for curve in edge_u:
            g = curve
            for axis in ("x", "y", "z"):
                angle = rng.choice([90, 180, 270])
                g = rotate_point_cloud(g, angle, axis)
            out.append(g)
        edge_u = np.stack(out)
    return edge_u.astype(np.float32)


# ---------------------------------------------------------------------------
# LDM stages


def _maybe_rotate_pos(rng, aug, surf_pos, extra_grids=()):
    """50% triple-axis rotation of bbox corners (+ ncs grids un-normalized)."""
    if not (aug and rng.random() > 0.5):
        return (surf_pos,) + tuple(extra_grids)
    corners = bbox_corners(surf_pos)
    arrays = [corners] + list(extra_grids)
    normalized = [True] + [False] * len(extra_grids)
    arrays = random_rotate_grids(rng, *arrays, normalized_mask=normalized)
    new_pos = get_bbox(arrays[0]).reshape(len(surf_pos), 6)
    return (new_pos,) + tuple(arrays[1:])


def assemble_surfpos(
    data: Dict,
    rng: np.random.Generator,
    max_face: int,
    bbox_scaled: float = 3.0,
    aug: bool = False,
) -> np.ndarray:
    surf_pos = data["surf_bbox_wcs"]
    if aug and rng.random() > 0.5:
        corners = bbox_corners(surf_pos)
        (corners,) = random_rotate_grids(rng, corners, normalized_mask=[True])
        surf_pos = get_bbox(corners).reshape(len(surf_pos), 6)
    surf_pos = surf_pos * bbox_scaled
    surf_pos = surf_pos[rng.permutation(len(surf_pos))]
    surf_pos = pad_repeat(surf_pos, max_face)
    surf_pos = surf_pos[rng.permutation(len(surf_pos))]
    return surf_pos.astype(np.float32)


def assemble_surfz(
    data: Dict,
    rng: np.random.Generator,
    max_face: int,
    bbox_scaled: float = 3.0,
    aug: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    surf_pos = data["surf_bbox_wcs"]
    surf_ncs = data["surf_ncs"]
    if aug and rng.random() > 0.5:
        corners = bbox_corners(surf_pos)
        corners, surf_ncs = random_rotate_grids(
            rng, corners, surf_ncs, normalized_mask=[True, False]
        )
        surf_pos = get_bbox(corners).reshape(len(surf_pos), 6)
    surf_pos = surf_pos * bbox_scaled
    perm = rng.permutation(len(surf_pos))
    surf_pos, surf_ncs = surf_pos[perm], surf_ncs[perm]
    surf_pos, surf_mask = pad_zero(surf_pos, max_face, return_mask=True)
    surf_ncs = pad_zero(surf_ncs, max_face)
    return (
        surf_pos.astype(np.float32),
        surf_ncs.astype(np.float32),
        surf_mask,
    )


def assemble_edgepos(
    data: Dict,
    rng: np.random.Generator,
    max_face: int,
    max_edge: int,
    bbox_scaled: float = 3.0,
    aug: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    surf_pos = data["surf_bbox_wcs"]
    edge_pos = data["edge_bbox_wcs"]
    surf_ncs = data["surf_ncs"]
    faceEdge_adj = data["faceEdge_adj"]

    if aug and rng.random() > 0.5:
        s_corners = bbox_corners(surf_pos)
        e_corners = bbox_corners(edge_pos)
        s_corners, e_corners, surf_ncs = random_rotate_grids(
            rng, s_corners, e_corners, surf_ncs, normalized_mask=[True, True, False]
        )
        surf_pos = get_bbox(s_corners).reshape(len(surf_pos), 6)
        edge_pos = get_bbox(e_corners).reshape(len(edge_pos), 6)

    surf_pos = surf_pos * bbox_scaled
    edge_pos = edge_pos * bbox_scaled

    # mating duplication + per-face shuffle + pad_repeat over edge slots
    edge_pos_new = []
    for adj in faceEdge_adj:
        pos = edge_pos[adj]
        pos = pos[rng.permutation(len(pos))]
        pos = pad_repeat(pos, max_edge)
        pos = pos[rng.permutation(len(pos))]
        edge_pos_new.append(pos)
    edge_pos = np.stack(edge_pos_new)

    perm = rng.permutation(len(surf_pos))
    surf_pos, edge_pos, surf_ncs = surf_pos[perm], edge_pos[perm], surf_ncs[perm]

    surf_pos, surf_mask = pad_zero(surf_pos, max_face, return_mask=True)
    surf_ncs = pad_zero(surf_ncs, max_face)
    edge_pos = pad_zero(edge_pos, max_face)
    return (
        edge_pos.astype(np.float32),
        surf_ncs.astype(np.float32),
        surf_pos.astype(np.float32),
        surf_mask,
    )


def assemble_edgez(
    data: Dict,
    rng: np.random.Generator,
    max_face: int,
    max_edge: int,
    bbox_scaled: float = 3.0,
    aug: bool = False,
):
    """Returns (edge_ncs, edge_pos, edge_mask, surf_ncs, surf_pos, vert_pos)."""
    surf_pos = data["surf_bbox_wcs"]
    edge_pos = data["edge_bbox_wcs"]
    surf_ncs = data["surf_ncs"]
    edge_ncs = data["edge_ncs"]
    corner_wcs = data["corner_wcs"]
    faceEdge_adj = data["faceEdge_adj"]

    if aug and rng.random() > 0.5:
        s_corners = bbox_corners(surf_pos)
        e_corners = bbox_corners(edge_pos)
        s_corners, e_corners, corner_wcs, surf_ncs, edge_ncs = random_rotate_grids(
            rng,
            s_corners,
            e_corners,
            corner_wcs,
            surf_ncs,
            edge_ncs,
            normalized_mask=[True, True, True, False, False],
        )
        surf_pos = get_bbox(s_corners).reshape(len(surf_pos), 6)
        edge_pos = get_bbox(e_corners).reshape(len(edge_pos), 6)

    surf_pos = surf_pos * bbox_scaled
    edge_pos = edge_pos * bbox_scaled
    corner_wcs = corner_wcs * bbox_scaled

    # mating duplication with lexsort-canonicalized endpoint pairs
    e_pos_d, e_ncs_d, v_pos_d = [], [], []
    for adj in faceEdge_adj:
        e_ncs_d.append(edge_ncs[adj])
        e_pos_d.append(edge_pos[adj])
        corners = corner_wcs[adj]
        corners_sorted = []
        for corner in corners:
            order = np.lexsort((corner[:, 2], corner[:, 1], corner[:, 0]))
            corners_sorted.append(corner[order].flatten())
        v_pos_d.append(np.stack(corners_sorted))

    e_pos_new, e_ncs_new, v_pos_new, masks = [], [], [], []
    for pos, ncs, vert in zip(e_pos_d, e_ncs_d, v_pos_d):
        perm = rng.permutation(len(pos))
        pos, ncs, vert = pos[perm], ncs[perm], vert[perm]
        pos, mask = pad_zero(pos, max_edge, return_mask=True)
        ncs = pad_zero(ncs, max_edge)
        vert = pad_zero(vert, max_edge)
        e_pos_new.append(pos)
        e_ncs_new.append(ncs)
        v_pos_new.append(vert)
        masks.append(mask)

    edge_pos = np.stack(e_pos_new)
    edge_ncs = np.stack(e_ncs_new)
    edge_mask = np.stack(masks)
    vert_pos = np.stack(v_pos_new)

    perm = rng.permutation(len(surf_pos))
    surf_pos = surf_pos[perm]
    edge_pos = edge_pos[perm]
    surf_ncs = surf_ncs[perm]
    edge_ncs = edge_ncs[perm]
    edge_mask = edge_mask[perm]
    vert_pos = vert_pos[perm]

    surf_pos = pad_zero(surf_pos, max_face)
    surf_ncs = pad_zero(surf_ncs, max_face)
    edge_pos = pad_zero(edge_pos, max_face)
    edge_ncs = pad_zero(edge_ncs, max_face)
    vert_pos = pad_zero(vert_pos, max_face)
    pad_rows = np.ones((max_face - len(edge_mask), *edge_mask.shape[1:]), dtype=bool)
    edge_mask = np.concatenate([edge_mask, pad_rows], 0)

    return (
        edge_ncs.astype(np.float32),
        edge_pos.astype(np.float32),
        edge_mask,
        surf_ncs.astype(np.float32),
        surf_pos.astype(np.float32),
        vert_pos.astype(np.float32),
    )
