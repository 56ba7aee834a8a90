"""Shared-vertex detection: recover topology from duplicated edge sets.

Host-side numpy re-implementation of the reference algorithm
(``utils.py:403-585``). Generated edges are duplicated per adjacent face;
their endpoints must be merged back into unique vertices:

  1. per face, close the wire loop by matching each edge endpoint to its
     nearest non-self endpoint -- first on endpoints derived from the edge
     bboxes, falling back to the predicted vertex positions ("[PASS]" /
     fallback logic at ``utils.py:473-498``); a face whose matching does
     not produce exactly one partner per endpoint aborts the sample;
  2. merge across faces: each intra-face merged pair is matched to the
     nearest pair center on OTHER faces (mating edges live on 2 faces);
  3. iteratively union overlapping merge groups (T-junctions), drop subset
     groups, then merge groups whose centers are closer than 0.1;
  4. unique vertex = group centroid, un-scaled by /3.

Raises PostprocessError (caller skips the sample, like the reference's
try/except at ``sample.py:332-336``).

The port's own copy of ``brepgen_tpu/postprocess/vertex_merge.py``, unchanged in behaviour.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


class PostprocessError(RuntimeError):
    pass


def edge2loop(face_edges: np.ndarray) -> np.ndarray:
    """[k, 2, 3] endpoint pairs -> sorted unique [m, 2] endpoint-id merges.

    Endpoint ids are 2*edge for start, 2*edge+1 for end. Each endpoint is
    paired with its nearest endpoint excluding its own edge's endpoints.
    """
    flat = face_edges.reshape(-1, 3)
    merged = []
    for ei, startend in enumerate(face_edges):
        self_ids = {2 * ei, 2 * ei + 1}
        for side in (0, 1):
            d = np.linalg.norm(flat - startend[side], axis=1)
            order = [i for i in np.argsort(d, kind="stable") if i not in self_ids]
            merged.append(sorted([2 * ei + side, order[0]]))
    return np.unique(np.array(merged), axis=0)


def edge2loop_greedy(face_edges: np.ndarray) -> np.ndarray:
    """Recovery variant of :func:`edge2loop`: greedy min-distance PERFECT
    matching over the face's 2k endpoints instead of nearest-neighbor.

    In a closed wire every vertex is shared by exactly two of the face's
    edges, i.e. the correct endpoint merge IS a perfect matching; strict
    ``edge2loop`` only finds it when the nearest-neighbor relation happens
    to be consistent. Greedy matching always produces k pairs, so the
    merge-count invariant holds structurally; geometric quality is judged
    downstream (edge pairing, joint optimization, B-rep sewing). The final
    leftover pair may be an edge's own two endpoints -- kept as a closed
    curve (circle) merge rather than rejected.

    No reference analogue: the reference aborts the sample outright when
    loop closure fails (``utils.py:473-498``).
    """
    flat = face_edges.reshape(-1, 3)
    n = len(flat)
    cands = sorted(
        (float(np.linalg.norm(flat[i] - flat[j])), i, j)
        for i in range(n) for j in range(i + 1, n) if i // 2 != j // 2
    )
    used = set()
    merged = []
    for _, i, j in cands:
        if i not in used and j not in used:
            used.update((i, j))
            merged.append([i, j])
    rest = [i for i in range(n) if i not in used]
    for i, j in zip(rest[::2], rest[1::2]):  # same-edge leftovers: closed curve
        merged.append([i, j])
    return np.unique(np.array(merged), axis=0)


def _keep_largest(groups: List[List[int]]) -> List[List[int]]:
    """Drop groups that are strict subsets of another; dedup identical."""
    sets = [frozenset(g) for g in groups]
    out, seen = [], set()
    for i, s1 in enumerate(sets):
        if any(i != j and s1 < s2 for j, s2 in enumerate(sets)):
            continue
        if s1 not in seen:
            seen.add(s1)
            out.append(sorted(s1))
    return out


def proximity_remerge(
    total_ids: List[List[int]],
    flat: np.ndarray,
    recovery: bool = False,
    info: dict = None,
) -> List[List[int]]:
    """Re-merge vertex groups whose centers are < 0.1 apart (deep
    T-junctions).

    When a group sits within 0.1 of TWO others (a chain of close
    centers), the reference's pairwise update (utils.py:565-572) emits
    that group's members into several output groups, and the sample dies
    downstream at the one-group-per-endpoint assert (utils.py:602; our
    detect_shared_edge raises 'endpoint in multiple groups'). Strict
    mode reproduces that exactly; in recovery mode, merge the connected
    components of the <0.1 graph instead -- output is identical when
    every component is a simple pair, and a valid partition otherwise.
    """
    centers = np.array([flat[g].mean(0) for g in total_ids])
    dists = np.linalg.norm(centers[:, None] - centers[None], axis=2)
    lower = np.tril(np.ones_like(dists, bool), k=-1)
    rows, cols = np.where((dists < 0.1) & lower)
    chained = len(rows) and len(set(rows) | set(cols)) < 2 * len(rows)
    if recovery and chained:
        parent = list(range(len(total_ids)))

        def find(x: int) -> int:
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        for r, c in zip(rows, cols):
            parent[find(int(r))] = find(int(c))
        comps: Dict[int, List[int]] = {}
        for i in range(len(total_ids)):
            comps.setdefault(find(i), []).extend(total_ids[i])
        if info is not None:
            info["chained_proximity_merges"] = len(rows)
        return list(comps.values())
    updated = [total_ids[r] + total_ids[c] for r, c in zip(rows, cols)]
    for i, g in enumerate(total_ids):
        if i not in rows and i not in cols:
            updated.append(g)
    return updated


def detect_shared_vertex(
    edgeV_cad: np.ndarray,     # [nf, ne, 6] predicted endpoint pairs (scaled x3)
    edge_mask_cad: np.ndarray, # [nf, ne] True = masked
    edgeV_bbox: List[np.ndarray],  # per face [k, 2, 3] endpoints from bboxes (wcs)
    recovery: bool = False,
    info: dict = None,
    greedy_closure: bool = True,   # rung-5 ablation knob (tests/ablation)
) -> Tuple[np.ndarray, Dict[int, List[int]]]:
    edge_counts = (~edge_mask_cad).sum(1)
    edge_id_offset = 2 * np.concatenate([[0], np.cumsum(edge_counts)])[:-1]

    used_vertex = []
    face_sep_merges = []
    rescued_faces = 0
    for face_idx in range(len(edgeV_cad)):
        face_edges = edgeV_cad[face_idx][~edge_mask_cad[face_idx]].reshape(-1, 2, 3)
        bbox_edges = edgeV_bbox[face_idx]
        start = edge_id_offset[face_idx]

        try:
            merged = edge2loop(bbox_edges)
            if len(merged) == len(face_edges):
                face_sep_merges.append(start + merged)
                used_vertex.append(bbox_edges * 3)  # back to x3-scaled space
                continue

            merged = edge2loop(face_edges)
            if len(merged) == len(face_edges):
                face_sep_merges.append(start + merged)
                used_vertex.append(face_edges)
                continue
        except IndexError:
            # a 1-edge face has no non-self nearest neighbor; in strict
            # mode this propagates (reference parity -- the sample dies),
            # in recovery mode rung 5 below may still close it as a circle
            if not recovery:
                raise

        if recovery and greedy_closure:
            # rung 5: nearest-neighbor closure failed both ways -- greedy
            # perfect matching of the bbox endpoints always yields k merges
            merged = edge2loop_greedy(bbox_edges)
            if len(merged) == len(face_edges):
                face_sep_merges.append(start + merged)
                used_vertex.append(bbox_edges * 3)
                rescued_faces += 1
                continue

        raise PostprocessError(f"face {face_idx}: loop closure failed")
    if info is not None:
        info["vertex_rescued_faces"] = rescued_faces

    total_pnts = np.vstack(used_vertex).reshape(-1, 2, 3)
    flat = total_pnts.reshape(-1, 3)

    # match each intra-face pair to the nearest pair on other faces
    total_ids: List[List[int]] = []
    for face_idx, face_merge in enumerate(face_sep_merges):
        others = [m for i, m in enumerate(face_sep_merges) if i != face_idx]
        others = np.vstack(others)
        other_centers = flat[others].mean(1)
        for merge_id in face_merge:
            center = flat[merge_id].mean(0)
            d = np.linalg.norm(other_centers - center, axis=1)
            partner = others[np.argmin(d)]
            total_ids.append(list(partner) + list(merge_id))

    # iterative union of overlapping groups (T-junctions)
    while True:
        no_merge = True
        result: List[List[int]] = []
        for i in range(len(total_ids)):
            performed = False
            for j in range(i + 1, len(total_ids)):
                a, b = set(total_ids[i]), set(total_ids[j])
                union = a | b
                if len(union) > max(len(a), len(b)) and a & b:
                    result.append(list(union))
                    performed = True
                    no_merge = False
                    break
            if not performed:
                result.append(total_ids[i])
        total_ids = result
        if no_merge:
            break

    total_ids = _keep_largest(total_ids)

    total_ids = proximity_remerge(total_ids, flat, recovery, info)

    unique_vertices = np.vstack([flat[g].mean(0) / 3.0 for g in total_ids])
    new_vertex_dict = {i: g for i, g in enumerate(total_ids)}
    return unique_vertices, new_vertex_dict
