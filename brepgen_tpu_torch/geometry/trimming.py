"""Loop ordering and UV-domain face trimming for tessellation.

The reference trims faces with OpenCASCADE wires + ShapeFix
(``utils.py:819-931``). Native equivalent used for tessellation/STL:

  * ``order_loops``: walk each face's edges through the vertex adjacency
    into closed loops; the outer loop is the one with the largest bbox
    diagonal (same heuristic as ``utils.py:897-905``).
  * ``trim_face_grid``: map the boundary loops into the face's UV index
    space (nearest grid sample), then keep grid cells whose centers are
    inside the boundary polygon(s) by even-odd crossing -- holes from
    inner loops fall out automatically. Falls back to the full grid if
    the mapped polygon is degenerate.

The port's own copy of ``brepgen_tpu/geometry/trimming.py``. The three
cell helpers run in the port's native host library
(``geometry/native_bindings.py``, built with g++ at first use), as they do in
the JAX package where its library is built; the results match that path of
the JAX package exactly.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from brepgen_tpu_torch.data.augment import get_bbox_norm
from brepgen_tpu_torch.geometry.native_bindings import (
    cells_inside_polygons,
    nearest_grid_index,
    tessellate_cells,
)


def order_loops(
    face_edge_ids: Sequence[int], edge_vertex_adj: np.ndarray
) -> List[List[Tuple[int, bool]]]:
    """Group a face's edges into ordered closed loops.

    Returns loops as lists of (edge_id, forward) where ``forward`` means
    the edge is traversed start->end.

    ``face_edge_ids`` may repeat an edge id: a face can traverse the same
    unique edge twice (a seam, e.g. a cylinder side wall closing on
    itself). Each occurrence is walked independently -- a dict keyed by
    edge id would silently collapse the multiplicity and misreport the
    wire as an open chain.
    """
    remaining = {
        slot: (int(e), (int(edge_vertex_adj[e][0]), int(edge_vertex_adj[e][1])))
        for slot, e in enumerate(face_edge_ids)
    }
    loops = []
    while remaining:
        s0 = next(iter(remaining))
        e0, (v0, v1) = remaining.pop(s0)
        loop = [(e0, True)]
        current = v1
        start = v0
        while current != start:
            found = False
            for s, (e, (a, b)) in list(remaining.items()):
                if a == current:
                    loop.append((e, True))
                    current = b
                    del remaining[s]
                    found = True
                    break
                if b == current:
                    loop.append((e, False))
                    current = a
                    del remaining[s]
                    found = True
                    break
            if not found:
                break  # open chain -- treat as a loop anyway
        loops.append(loop)
    return loops


def outer_loop_index(loops, edge_wcs: np.ndarray) -> int:
    spans = []
    for loop in loops:
        pts = np.concatenate([edge_wcs[e].reshape(-1, 3) for e, _ in loop])
        spans.append(get_bbox_norm(pts))
    return int(np.argmax(spans))


def loop_polyline(loop, edge_wcs: np.ndarray) -> np.ndarray:
    """Concatenate oriented edge curves into one closed 3D polyline."""
    parts = []
    for e, forward in loop:
        c = edge_wcs[e]
        parts.append(c if forward else c[::-1])
    return np.concatenate(parts)


def loop_uv_polygon(loop, grid: np.ndarray, edge_wcs: np.ndarray) -> np.ndarray:
    """Map a loop's 3D polyline onto the face's UV index space."""
    poly3d = loop_polyline(loop, edge_wcs)
    uv = nearest_grid_index(poly3d, grid).astype(float)
    keep = np.ones(len(uv), bool)
    keep[1:] = np.any(np.diff(uv, axis=0) != 0, axis=1)
    return uv[keep]


def _signed_area(poly: np.ndarray) -> float:
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))


def _reverse_loop(loop):
    return [(e, not forward) for e, forward in reversed(loop)]


def orient_loops_uv(loops, grid: np.ndarray, edge_wcs: np.ndarray):
    """Order a face's loops outer-first and fix their UV winding.

    STEP convention for a face bound (ISO 10303-42): the outer bound runs
    counter-clockwise in the surface's (u, v) parameterization, inner
    bounds (holes) clockwise, with ``same_sense = .T.``. The reference
    gets this from OCC's ShapeFix (``utils.py:788-816``); here the winding
    is computed from the loop's signed area in UV index space.

    Returns the reordered/refit loops (outer first). Loops whose UV image
    is degenerate (< 3 distinct points) are kept as-is.
    """
    if not loops:
        return loops
    outer = outer_loop_index(loops, edge_wcs)
    ordered = [loops[outer]] + [l for i, l in enumerate(loops) if i != outer]
    out = []
    for i, loop in enumerate(ordered):
        uv = loop_uv_polygon(loop, grid, edge_wcs)
        if len(uv) >= 3:
            area = _signed_area(uv)
            want_ccw = i == 0
            if (area < 0) == want_ccw:
                loop = _reverse_loop(loop)
        out.append(loop)
    return out


def trim_face_grid(
    grid: np.ndarray,                 # [Nu, Nv, 3]
    loops,                            # from order_loops
    edge_wcs: np.ndarray,
) -> np.ndarray:
    """Tessellate the trimmed face -> triangles [T, 3, 3]."""
    Nu, Nv, _ = grid.shape
    polys = []
    for loop in loops:
        poly3d = loop_polyline(loop, edge_wcs)
        uv = nearest_grid_index(poly3d, grid)
        # drop consecutive duplicates
        keep = np.ones(len(uv), bool)
        keep[1:] = np.any(np.diff(uv, axis=0) != 0, axis=1)
        uv = uv[keep]
        if len(uv) >= 3:
            polys.append(uv)

    if polys:
        inside = cells_inside_polygons(polys, Nu, Nv)
        if not inside.any():
            inside = np.ones((Nu - 1, Nv - 1), bool)
    else:
        inside = np.ones((Nu - 1, Nv - 1), bool)

    return tessellate_cells(grid, inside)
