"""B-rep assembly: fitted parametric geometry + trimmed tessellation.

Native counterpart of the reference's OCC pipeline (``utils.py:819-947``):
fit B-spline surfaces (degree 3) to the optimized 32x32 grids and B-spline
curves to the 32-point edges, order each face's edges into outer/inner
loops, trim the face tessellation by those loops, and export STEP + STL.
STEP export is topological (``write_step_brep``: trimmed ADVANCED_FACEs
sewn into a MANIFOLD_SOLID_BREP) whenever the recovered topology is sound
— every loop closed and every edge shared by exactly two faces — and falls
back to loose spline geometry otherwise.

The port's own copy of ``brepgen_tpu/geometry/brep_build.py`` without the
OCC branch: pythonocc-core is not a dependency of the port, so it always
builds the native B-spline solid.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np

from brepgen_tpu_torch.geometry import step_writer
from brepgen_tpu_torch.geometry.bspline import (
    BsplineCurve,
    BsplineSurface,
    fit_bspline_curve,
    fit_bspline_surface,
)
from brepgen_tpu_torch.geometry.stl import write_stl
from brepgen_tpu_torch.geometry.trimming import orient_loops_uv, order_loops, trim_face_grid


class SolidMesh(NamedTuple):
    """Assembled solid: parametric geometry + per-face trimmed triangles."""

    surfaces: List[BsplineSurface]
    curves: List[BsplineCurve]
    face_triangles: List[np.ndarray]
    face_loops: List[list]                    # per face, outer loop first
    vertices: Optional[np.ndarray] = None     # [V, 3]
    edge_vertex_adj: Optional[np.ndarray] = None  # [E, 2]

    def triangles(self) -> np.ndarray:
        return np.concatenate([t for t in self.face_triangles if len(t)], axis=0)

    def write_stl(self, path: str) -> None:
        write_stl(path, self.triangles())

    def topology_ok(self) -> bool:
        """True when loops close, each edge borders exactly two faces, and
        the shell is orientable (some assignment of per-face flips makes
        every shared edge traversed once in each direction — required for
        a conformant MANIFOLD_SOLID_BREP; closed edges are exempt because
        the STEP writer can toggle their direction freely)."""
        if self.vertices is None or self.edge_vertex_adj is None:
            return False
        use = {}
        for loops in self.face_loops:
            for loop in loops:
                if not loop:
                    return False
                # closed chain over vertex ids
                ends = []
                for e, forward in loop:
                    a, b = self.edge_vertex_adj[int(e)]
                    ends.append((a, b) if forward else (b, a))
                    use[int(e)] = use.get(int(e), 0) + 1
                if any(
                    ends[i][1] != ends[(i + 1) % len(ends)][0]
                    for i in range(len(ends))
                ):
                    return False
        if not (use and all(c == 2 for c in use.values())):
            return False
        closed = frozenset(
            e for e in use
            if self.edge_vertex_adj[e][0] == self.edge_vertex_adj[e][1]
        )
        _, conflicts = step_writer._coherent_face_flips(self.face_loops, closed)
        return not conflicts

    def write_step(self, path: str, name: str = "brepgen_solid") -> None:
        if self.topology_ok():
            step_writer.write_step_brep(
                path,
                self.surfaces,
                self.curves,
                self.face_loops,
                self.vertices,
                self.edge_vertex_adj,
                name=name,
            )
        else:
            step_writer.write_step(path, self.surfaces, self.curves, name=name)


def vertices_from_edges(
    edge_wcs: np.ndarray, edge_vertex_adj: np.ndarray
) -> np.ndarray:
    """Estimate unique vertex positions from edge endpoints.

    Assigns each edge's sampled endpoints to its adjacency pair by
    nearest-distance (the post-processor's lexsort canonicalization can
    store vertex pairs against the curve's sampling direction), then
    averages. One correction sweep after the initial adjacency-order guess
    is enough: endpoints were snapped together by ``joint_optimize``.
    """
    edge_vertex_adj = np.asarray(edge_vertex_adj, int)
    n_vert = int(edge_vertex_adj.max()) + 1
    p0, p1 = edge_wcs[:, 0], edge_wcs[:, -1]

    def mean_positions(swap: np.ndarray) -> np.ndarray:
        acc = np.zeros((n_vert, 3))
        cnt = np.zeros(n_vert)
        a = np.where(swap, edge_vertex_adj[:, 1], edge_vertex_adj[:, 0])
        b = np.where(swap, edge_vertex_adj[:, 0], edge_vertex_adj[:, 1])
        np.add.at(acc, a, p0)
        np.add.at(acc, b, p1)
        np.add.at(cnt, a, 1)
        np.add.at(cnt, b, 1)
        return acc / np.maximum(cnt, 1)[:, None]

    swap = np.zeros(len(edge_wcs), bool)
    pos = mean_positions(swap)
    d_keep = np.linalg.norm(p0 - pos[edge_vertex_adj[:, 0]], axis=1) + np.linalg.norm(
        p1 - pos[edge_vertex_adj[:, 1]], axis=1
    )
    d_swap = np.linalg.norm(p0 - pos[edge_vertex_adj[:, 1]], axis=1) + np.linalg.norm(
        p1 - pos[edge_vertex_adj[:, 0]], axis=1
    )
    swap = d_swap < d_keep
    return mean_positions(swap)


def construct_brep(
    surf_wcs: np.ndarray,            # [F, 32, 32, 3]
    edge_wcs: np.ndarray,            # [E, 32, 3]
    face_edge_adj: Sequence[Sequence[int]],
    edge_vertex_adj: np.ndarray,     # [E, 2]
    vertices: Optional[np.ndarray] = None,  # [V, 3] unique vertex positions
) -> SolidMesh:
    surfaces = [fit_bspline_surface(g) for g in surf_wcs]
    curves = [fit_bspline_curve(c) for c in edge_wcs]
    if vertices is None:
        vertices = vertices_from_edges(edge_wcs, edge_vertex_adj)

    face_tris: List[np.ndarray] = []
    face_loops: List[list] = []
    for f, grid in enumerate(surf_wcs):
        loops = order_loops(face_edge_adj[f], edge_vertex_adj)
        loops = orient_loops_uv(loops, grid, edge_wcs)
        face_loops.append(loops)
        tris = trim_face_grid(grid, loops, edge_wcs)
        face_tris.append(tris)

    return SolidMesh(
        surfaces, curves, face_tris, face_loops,
        vertices=np.asarray(vertices, float),
        edge_vertex_adj=np.asarray(edge_vertex_adj, int),
    )
