"""Per-solid B-rep sample schema (pickle-dict parity with the reference).

The port's own numpy copy of ``brepgen_tpu/data/schema.py``.

The reference extractor writes one pickle per solid with this exact key
order (``data_process/process_brep.py:127-139`` plus a trailing ``uid`` set
by ``process()``); key ORDER matters because downstream code unpacks with
``dict.values()`` (e.g. ``dataset.py:31,141,309``).

Keys:
  surf_wcs     [nf, 32, 32, 3] world-coord UV grids (solid scaled to [-1,1]^3)
  edge_wcs     [ne, 32, 3]     world-coord u-grids
  surf_ncs     [nf, 32, 32, 3] per-face normalized grids (local [-1,1]^3)
  edge_ncs     [ne, 32, 3]     per-edge normalized grids
  corner_wcs   [ne, 2, 3]      start/end vertex of each edge (world coords)
  edgeFace_adj [ne, 2]         the two faces adjacent to each edge
  edgeCorner_adj [ne, 2]       unique-vertex ids of each edge's endpoints
  faceEdge_adj list[nf] of int arrays: edge ids bounding each face
  surf_bbox_wcs [nf, 6]        min/max corner of each face's AABB
  edge_bbox_wcs [ne, 6]        min/max corner of each edge's AABB
  corner_unique [nv, 3]        deduplicated vertex positions
  uid          str
"""

from __future__ import annotations

import pickle
from typing import Dict, List

import numpy as np

BREP_KEYS = (
    "surf_wcs",
    "edge_wcs",
    "surf_ncs",
    "edge_ncs",
    "corner_wcs",
    "edgeFace_adj",
    "edgeCorner_adj",
    "faceEdge_adj",
    "surf_bbox_wcs",
    "edge_bbox_wcs",
    "corner_unique",
    "uid",
)


def validate_brep(data: Dict) -> None:
    keys = list(data.keys())
    assert keys == list(BREP_KEYS), f"key order mismatch: {keys}"
    nf = len(data["surf_wcs"])
    ne = len(data["edge_wcs"])
    assert data["surf_ncs"].shape == (nf, 32, 32, 3)
    assert data["edge_ncs"].shape == (ne, 32, 3)
    assert data["corner_wcs"].shape == (ne, 2, 3)
    assert data["edgeFace_adj"].shape == (ne, 2)
    assert data["edgeCorner_adj"].shape == (ne, 2)
    assert len(data["faceEdge_adj"]) == nf
    assert data["surf_bbox_wcs"].shape == (nf, 6)
    assert data["edge_bbox_wcs"].shape == (ne, 6)
    # geometry invariants
    assert np.abs(data["surf_wcs"]).max() <= 1.0 + 1e-5
    assert np.abs(data["surf_ncs"]).max() <= 1.0 + 1e-4
    assert np.abs(data["edge_ncs"]).max() <= 1.0 + 1e-4
    # each face's edges reference valid edge ids; each edge maps to 2 faces
    for adj in data["faceEdge_adj"]:
        assert len(adj) > 0 and max(adj) < ne
    assert data["edgeCorner_adj"].max() < len(data["corner_unique"])


def save_brep_pkl(path: str, data: Dict) -> None:
    validate_brep(data)
    with open(path, "wb") as f:
        pickle.dump(data, f)


def load_brep_pkl(path: str) -> Dict:
    with open(path, "rb") as f:
        return pickle.load(f)


def normalize_solid(
    surf_pnts: List[np.ndarray],
    edge_pnts: List[np.ndarray],
    corner_pnts: np.ndarray,
):
    """Normalize a solid to the [-1,1]^3 cube and each primitive to its own
    local cube (reference ``process_brep.py:13-62``).

    Returns (surfs_wcs, edges_wcs, surfs_ncs, edges_ncs, corner_wcs).
    """
    total = np.asarray(surf_pnts).reshape(-1, 3)
    min_vals, max_vals = total.min(0), total.max(0)
    offset = min_vals + (max_vals - min_vals) / 2
    scale = float(max(max_vals - min_vals))
    assert scale != 0, "scale is zero"

    corner_wcs = (corner_pnts - offset) / (scale * 0.5)

    def local_norm(p_wcs):
        flat = p_wcs.reshape(-1, 3)
        mn, mx = flat.min(0), flat.max(0)
        loc_off = mn + (mx - mn) / 2
        loc_scale = float(max(mx - mn))
        assert loc_scale != 0, "scale is zero"
        return (p_wcs - loc_off) / (loc_scale * 0.5)

    surfs_wcs, surfs_ncs, edges_wcs, edges_ncs = [], [], [], []
    for p in surf_pnts:
        w = (p - offset) / (scale * 0.5)
        surfs_wcs.append(w)
        surfs_ncs.append(local_norm(w))
    for p in edge_pnts:
        w = (p - offset) / (scale * 0.5)
        edges_wcs.append(w)
        edges_ncs.append(local_norm(w))

    return (
        np.stack(surfs_wcs),
        np.stack(edges_wcs),
        np.stack(surfs_ncs),
        np.stack(edges_ncs),
        corner_wcs,
    )


def build_brep_sample(
    surf_pnts: List[np.ndarray],
    edge_pnts: List[np.ndarray],
    corner_pnts: np.ndarray,  # [ne, 2, 3]
    faceEdge_adj: List[np.ndarray],
    edgeFace_adj: np.ndarray,
    uid: str,
) -> Dict:
    """Assemble the full schema dict from raw sampled primitives."""
    surfs_wcs, edges_wcs, surfs_ncs, edges_ncs, corner_wcs = normalize_solid(
        surf_pnts, edge_pnts, corner_pnts
    )

    # Merge duplicate corners (reference rounds to 4 decimals).
    corner_wcs = np.round(corner_wcs, 4)
    corner_unique = []
    for c in corner_wcs.reshape(-1, 3):
        if not any(np.allclose(c, u, atol=0) for u in corner_unique):
            corner_unique.append(c)
    corner_unique = np.stack(corner_unique)

    edgeCorner_adj = []
    for ec in corner_wcs:
        s = int(np.where((corner_unique == ec[0]).all(1))[0][0])
        e = int(np.where((corner_unique == ec[1]).all(1))[0][0])
        edgeCorner_adj.append([s, e])
    edgeCorner_adj = np.array(edgeCorner_adj)

    def bboxes(pnt_list):
        out = []
        for p in pnt_list:
            flat = p.reshape(-1, 3)
            out.append(np.concatenate([flat.min(0), flat.max(0)]))
        return np.vstack(out)

    data = {
        "surf_wcs": surfs_wcs.astype(np.float32),
        "edge_wcs": edges_wcs.astype(np.float32),
        "surf_ncs": surfs_ncs.astype(np.float32),
        "edge_ncs": edges_ncs.astype(np.float32),
        "corner_wcs": corner_wcs.astype(np.float32),
        "edgeFace_adj": np.asarray(edgeFace_adj),
        "edgeCorner_adj": edgeCorner_adj,
        "faceEdge_adj": [np.asarray(a) for a in faceEdge_adj],
        "surf_bbox_wcs": bboxes(surfs_wcs).astype(np.float32),
        "edge_bbox_wcs": bboxes(edges_wcs).astype(np.float32),
        "corner_unique": corner_unique.astype(np.float32),
        "uid": uid,
    }
    validate_brep(data)
    return data
