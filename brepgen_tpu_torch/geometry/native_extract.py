"""Native (OCC-free) STEP -> pkl extraction.

The reference extraction (``data_process/process_brep.py:13-231``) needs
OpenCASCADE to load STEP and sample UV grids. The native STEP reader plus
the B-spline and analytic evaluators cover the same pipeline end to end
for the geometry mainstream AP203/214 files carry — B-spline surfaces and
curves (everything this framework exports), the elementary analytic
classes (plane/cylinder/cone/sphere/torus, line/circle/ellipse), and
swept/offset surfaces (extrusion, revolution, offset — ``swept.py``):

  parse topology (``step_reader``) -> sample each edge's curve at 32
  parameters (analytic curves trimmed by their vertex points) -> sample
  each face's surface on a 32x32 grid: B-splines over their full knot
  domain (the reference samples the FULL parametric domain too,
  ``convert_utils.py:290-313``), analytic surfaces over the UV box their
  boundary samples span (what OCC's BRepTools::UVBounds returns) ->
  adjacency from the face bounds -> ``build_brep_sample``
  (normalization, corner merge, bboxes, schema).

The port's own copy of ``brepgen_tpu/geometry/native_extract.py``. The port
has no OCC backend (``geometry/occ_backend.py`` and ``occ_extract.py`` of the
JAX package need pythonocc), so ``process_main --input`` always extracts
through this module.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from brepgen_tpu_torch.data.schema import build_brep_sample
from brepgen_tpu_torch.geometry import analytic
from brepgen_tpu_torch.geometry.bspline import (
    BsplineCurve,
    BsplineSurface,
    NurbsCurve,
    NurbsSurface,
    eval_bspline_curve,
    eval_bspline_surface,
    eval_nurbs_curve,
    eval_nurbs_surface,
)
from brepgen_tpu_torch.geometry.step_reader import StepBrep, load_brep
from brepgen_tpu_torch.geometry.swept import OffsetSurface, TrimmedSurface

MAX_FACE = 70  # reference process_brep.py:11


def _domain(knots: np.ndarray) -> tuple:
    return float(knots[0]), float(knots[-1])


def sample_curve_grid(curve, p_start=None, p_end=None, num: int = 32) -> np.ndarray:
    """[num, 3] points along an edge's curve.

    B-splines sample their full knot domain; analytic curves are trimmed
    by the edge's vertex positions (periodic convention in
    ``analytic.curve_param_range``).
    """
    if isinstance(curve, (BsplineCurve, NurbsCurve)):
        t0, t1 = _domain(curve.knots)
        t = np.linspace(t0, t1, num)
        if isinstance(curve, NurbsCurve):
            return eval_nurbs_curve(curve, t)
        return eval_bspline_curve(curve, t)
    t0, t1 = analytic.curve_param_range(curve, p_start, p_end)
    return curve.eval(np.linspace(t0, t1, num))


def sample_surface_grid(surface, boundary_pts=None, num: int = 32) -> np.ndarray:
    """[num, num, 3] points over the face's parametric domain."""
    if isinstance(surface, (BsplineSurface, NurbsSurface)):
        u0, u1 = _domain(surface.knots_u)
        v0, v1 = _domain(surface.knots_v)
        u, v = np.linspace(u0, u1, num), np.linspace(v0, v1, num)
        if isinstance(surface, NurbsSurface):
            return eval_nurbs_surface(surface, u, v)
        return eval_bspline_surface(surface, u, v)
    if isinstance(surface, (OffsetSurface, TrimmedSurface)):
        # free-form base: sample its own domain (full knot domain for
        # offsets, the trim rectangle for rectangular trims)
        (u0, u1), (v0, v1) = surface.domain()
        return surface.eval_grid(
            np.linspace(u0, u1, num), np.linspace(v0, v1, num)
        )
    (u0, u1), (v0, v1) = analytic.surface_uv_domain(surface, boundary_pts)
    uu, vv = np.meshgrid(
        np.linspace(u0, u1, num), np.linspace(v0, v1, num), indexing="ij"
    )
    return surface.eval(uu, vv)


def extract_brep_sample(brep: StepBrep, uid: str, max_face: int = MAX_FACE) -> Optional[Dict]:
    """StepBrep -> schema pkl dict; None when the solid is out of scope
    (too many faces / non-manifold edges), mirroring the reference's skip
    semantics (process_brep.py:81,199-201)."""
    if not brep.faces or len(brep.faces) > max_face:
        return None

    # face -> edge ids from the bounds; edge -> faces inverted
    face_edges = []
    for face in brep.faces:
        ids = []
        for _outer, chain in face.bounds:
            ids += [ei for ei, _same in chain]
        face_edges.append(sorted(set(ids)))
    edge_faces: Dict[int, list] = {}
    for f, ids in enumerate(face_edges):
        for e in ids:
            edge_faces.setdefault(e, []).append(f)

    # sample every boundary edge once (analytic surface domains need the
    # non-manifold ones too), then keep only manifold edges for the schema
    edge_samples: Dict[int, np.ndarray] = {}
    for e in edge_faces:
        edge = brep.edges[e]
        edge_samples[e] = sample_curve_grid(
            edge.curve, brep.vertices[edge.v_start], brep.vertices[edge.v_end]
        )

    kept = sorted(e for e, fs in edge_faces.items() if len(set(fs)) == 2)
    if not kept:
        return None
    compact = {e: i for i, e in enumerate(kept)}

    surf_pnts = [
        sample_surface_grid(
            face.surface,
            np.concatenate([edge_samples[e] for e in ids])
            if ids else None,
        )
        for face, ids in zip(brep.faces, face_edges)
    ]
    edge_pnts, corners = [], []
    for e in kept:
        edge = brep.edges[e]
        edge_pnts.append(edge_samples[e])
        corners.append(
            np.stack([brep.vertices[edge.v_start], brep.vertices[edge.v_end]])
        )

    faceEdge_adj = [
        np.array(sorted(compact[e] for e in ids if e in compact), int)
        for ids in face_edges
    ]
    if any(len(a) == 0 for a in faceEdge_adj):
        return None
    edgeFace_adj = np.array([sorted(set(edge_faces[e])) for e in kept], int)

    return build_brep_sample(
        surf_pnts, edge_pnts, np.stack(corners), faceEdge_adj, edgeFace_adj, uid
    )


def extract_step_file(path: str, uid: Optional[str] = None) -> Optional[Dict]:
    import os

    uid = uid or os.path.splitext(os.path.basename(path))[0] + ".pkl"
    return extract_brep_sample(load_brep(path), uid)
