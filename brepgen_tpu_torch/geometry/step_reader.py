"""Native STEP (ISO 10303-21) reader for B-rep topology + B-spline geometry.

Counterpart of ``step_writer.write_step_brep`` and a native stand-in for
the reference's OCC-based STEP ingestion (``convert_utils.py:132-161``,
``STEPControl_Reader``): parses the entity graph, resolves the root
MANIFOLD_SOLID_BREP, and reconstructs vertices, edge curves, trimmed faces
(surface + ordered bounds), and the shell topology as numpy/NamedTuples.

Covers the entity subset mainstream AP203/AP214 B-rep exporters emit:
cartesian/vertex points, B-spline curves/surfaces with knots (incl.
rational complex records), the elementary analytic classes (PLANE,
CYLINDRICAL/CONICAL/SPHERICAL/TOROIDAL_SURFACE; LINE, CIRCLE, ELLIPSE
via ``geometry/analytic.py``), swept and offset surfaces
(SURFACE_OF_LINEAR_EXTRUSION / _OF_REVOLUTION / OFFSET_SURFACE via
``geometry/swept.py``), rectangular trims and trimmed curves
(RECTANGULAR_TRIMMED_SURFACE / TRIMMED_CURVE — delegated to the basis
where boundary projection already bounds the face, domain-restricted for
free-form bases), DEGENERATE_TOROIDAL_SURFACE, edge curves, oriented
edges, loops, face bounds, advanced/closed shell. Unsupported geometry raises per-entity (callers
skip that file); stray entities outside the shell graph are ignored —
enough to re-import our own exports and validate them as sewn solids
(``validate_solid``), and to ingest typical external CAD exports.

The port's own copy of ``brepgen_tpu/geometry/step_reader.py``.
"""

from __future__ import annotations

import re
from typing import Dict, List, NamedTuple, Tuple

import numpy as np

from brepgen_tpu_torch.geometry import analytic
from brepgen_tpu_torch.geometry.bspline import (
    BsplineCurve,
    BsplineSurface,
    NurbsCurve,
    NurbsSurface,
)


class StepEntity(NamedTuple):
    eid: int
    type: str
    args: list  # nested lists of tokens; refs resolved to ints via Ref


class Ref(int):
    """An entity reference (#n) distinguished from a plain integer."""


class StepEdge(NamedTuple):
    v_start: int
    v_end: int
    curve: object  # BsplineCurve or an analytic curve (Line/Circle/Ellipse)


class StepFace(NamedTuple):
    surface: object  # BsplineSurface or an analytic surface
    # per bound: (is_outer, [(edge_index, same_sense), ...])
    bounds: List[Tuple[bool, List[Tuple[int, bool]]]]


class StepBrep(NamedTuple):
    name: str
    vertices: np.ndarray      # [V, 3]
    edges: List[StepEdge]
    faces: List[StepFace]


_ENT_RE = re.compile(r"#(\d+)\s*=\s*(.+)", re.S)


def _tokenize(text: str) -> list:
    """Parse a STEP argument list into nested python lists of tokens."""
    out: list = []
    stack = [out]
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        if ch == "(":
            new: list = []
            stack[-1].append(new)
            stack.append(new)
            i += 1
        elif ch == ")":
            stack.pop()
            i += 1
        elif ch == ",":
            i += 1
        elif ch == "'":
            # STEP strings escape an embedded quote as '' (ISO 10303-21)
            j = i + 1
            parts: list = []
            while j < n:
                if text[j] == "'":
                    if j + 1 < n and text[j + 1] == "'":
                        parts.append("'")
                        j += 2
                        continue
                    break
                parts.append(text[j])
                j += 1
            stack[-1].append("".join(parts))
            i = j + 1
        elif ch == "#":
            j = i + 1
            while j < n and text[j].isdigit():
                j += 1
            stack[-1].append(Ref(text[i + 1 : j]))
            i = j
        elif ch == ".":
            # enum like .T. / .UNSPECIFIED.
            j = text.index(".", i + 1)
            stack[-1].append(text[i : j + 1])
            i = j + 1
        elif ch in " \t\r\n":
            i += 1
        elif ch in "*$":
            stack[-1].append(ch)
            i += 1
        else:
            j = i
            while j < n and text[j] not in "(),'# \t\r\n":
                j += 1
            tok = text[i:j]
            try:
                stack[-1].append(float(tok) if any(c in tok for c in ".Ee") else int(tok))
            except ValueError:
                stack[-1].append(tok)
            i = j
    return out


def _split_records(text: str) -> List[str]:
    """Split DATA-section text on ``;`` outside quoted strings.

    External STEP files routinely carry ``;`` (and ``''``-escaped quotes)
    inside string attributes — a naive ``split(';')`` silently drops every
    entity after the first such string.
    """
    records: List[str] = []
    buf: list = []
    in_str = False
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        if in_str:
            if ch == "'":
                if i + 1 < n and text[i + 1] == "'":
                    buf.append("''")
                    i += 2
                    continue
                in_str = False
            buf.append(ch)
        elif ch == "'":
            in_str = True
            buf.append(ch)
        elif ch == ";":
            records.append("".join(buf))
            buf = []
        else:
            buf.append(ch)
        i += 1
    if buf:
        records.append("".join(buf))
    return records


def parse_step(path: str) -> Dict[int, StepEntity]:
    """Parse a STEP file's DATA section into {entity id: StepEntity}."""
    text = open(path).read()
    m = re.search(r"DATA\s*;(.*?)ENDSEC\s*;", text, re.S)
    if not m:
        raise ValueError(f"{path}: no DATA section")
    entities: Dict[int, StepEntity] = {}
    for record in _split_records(m.group(1)):
        record = record.strip()
        if not record:
            continue
        em = _ENT_RE.match(record)
        if not em:
            continue
        eid = int(em.group(1))
        body = em.group(2).strip()
        # complex (multi-typed) entities '( A (...) B (...) )' — keep raw
        if body.startswith("("):
            entities[eid] = StepEntity(eid, "", [body])
            continue
        tm = re.match(r"([A-Z0-9_]+)\s*\((.*)\)\s*$", body, re.S)
        if not tm:
            continue
        entities[eid] = StepEntity(eid, tm.group(1), _tokenize(tm.group(2)))
    return entities


def _knot_vector(knots, mults) -> np.ndarray:
    return np.repeat(np.asarray(knots, float), np.asarray(mults, int))


def _frame(ents, eid: int) -> analytic.Frame:
    """AXIS2_PLACEMENT_3D -> Frame (axis / ref_direction may be ``$``)."""
    e = ents[eid]
    assert e.type == "AXIS2_PLACEMENT_3D", e.type
    origin = ents[e.args[1]].args[1]
    z = ents[e.args[2]].args[1] if isinstance(e.args[2], Ref) else None
    x = ents[e.args[3]].args[1] if isinstance(e.args[3], Ref) else None
    return analytic.make_frame(origin, z, x)


def _axis1_frame(ents, eid: int) -> analytic.Frame:
    """AXIS1_PLACEMENT (location + optional axis) -> Frame (x arbitrary)."""
    e = ents[eid]
    assert e.type == "AXIS1_PLACEMENT", e.type
    origin = ents[e.args[1]].args[1]
    z = ents[e.args[2]].args[1] if isinstance(e.args[2], Ref) else None
    return analytic.make_frame(origin, z, None)


def _vector(ents, eid: int) -> np.ndarray:
    """VECTOR(name, direction, magnitude) -> direction * magnitude."""
    e = ents[eid]
    assert e.type == "VECTOR", e.type
    direction = np.asarray(ents[e.args[1]].args[1], float)
    return direction * float(e.args[2])


def _complex_components(e: StepEntity) -> Dict[str, list]:
    """A complex (multi-supertype) record ``(A (...) B (...) ...)`` ->
    {supertype: tokenized args}. Used for rational B-splines, which STEP
    spells as B_SPLINE_*() + B_SPLINE_*_WITH_KNOTS() + RATIONAL_B_SPLINE_*()."""
    items = _tokenize(e.args[0])[0]
    comps: Dict[str, list] = {}
    i = 0
    while i < len(items):
        name = items[i]
        if i + 1 < len(items) and isinstance(items[i + 1], list):
            comps[name] = items[i + 1]
            i += 2
        else:
            comps[name] = []
            i += 1
    return comps


def _build_rational_curve(ents, comps):
    base = comps["B_SPLINE_CURVE"]          # degree, ctrl, form, closed, selfint
    wk = comps["B_SPLINE_CURVE_WITH_KNOTS"]  # mults, knots, spec
    degree = int(base[0])
    ctrl = np.array([ents[r].args[1] for r in base[1]], float)
    knots = _knot_vector(wk[1], wk[0])
    weights = comps.get("RATIONAL_B_SPLINE_CURVE")
    if weights is None:
        return BsplineCurve(degree, knots, ctrl)
    return NurbsCurve(degree, knots, ctrl, np.asarray(weights[0], float))


def _build_rational_surface(ents, comps):
    base = comps["B_SPLINE_SURFACE"]          # du, dv, ctrl grid, form, ...
    wk = comps["B_SPLINE_SURFACE_WITH_KNOTS"]  # mu, mv, ku, kv, spec
    du, dv = int(base[0]), int(base[1])
    grid = np.array([[ents[r].args[1] for r in row] for row in base[2]], float)
    ku = _knot_vector(wk[2], wk[0])
    kv = _knot_vector(wk[3], wk[1])
    weights = comps.get("RATIONAL_B_SPLINE_SURFACE")
    if weights is None:
        return BsplineSurface(du, dv, ku, kv, grid)
    return NurbsSurface(du, dv, ku, kv, grid, np.asarray(weights[0], float))


def _build_curve(ents, eid: int):
    """Bounded curve geometry: B-spline (incl. rational), or an elementary
    analytic class (trim parameters come later from the edge's vertices)."""
    e = ents[eid]
    if e.type == "" and e.args:  # complex record
        comps = _complex_components(e)
        if "B_SPLINE_CURVE_WITH_KNOTS" in comps:
            return _build_rational_curve(ents, comps)
        raise ValueError(f"unsupported complex curve entity #{eid}")
    if e.type == "B_SPLINE_CURVE_WITH_KNOTS":
        # args: name, degree, (ctrl refs), form, closed, self-intersect,
        #       (mults), (knots), spec
        degree = int(e.args[1])
        ctrl = np.array([ents[r].args[1] for r in e.args[2]], float)
        mults, knots = e.args[6], e.args[7]
        return BsplineCurve(degree, _knot_vector(knots, mults), ctrl)
    if e.type == "LINE":
        point = np.asarray(ents[e.args[1]].args[1], float)
        vec_e = ents[e.args[2]]  # VECTOR(name, direction, magnitude)
        direction = np.asarray(ents[vec_e.args[1]].args[1], float)
        return analytic.Line(point, direction * float(vec_e.args[2]))
    if e.type == "CIRCLE":
        return analytic.Circle(_frame(ents, e.args[1]), float(e.args[2]))
    if e.type == "ELLIPSE":
        return analytic.Ellipse(
            _frame(ents, e.args[1]), float(e.args[2]), float(e.args[3])
        )
    if e.type == "TRIMMED_CURVE":
        # args: name, basis, (trim_1), (trim_2), sense, master_repr.
        # The extractor re-trims analytic curves from the edge's vertex
        # points and samples B-splines over their knot domain, so the
        # basis carries everything downstream consumes; the trim selects
        # are redundant here.
        return _build_curve(ents, e.args[1])
    raise ValueError(f"unsupported curve entity {e.type}")


def _build_surface(ents, eid: int):
    e = ents[eid]
    if e.type == "" and e.args:  # complex record
        comps = _complex_components(e)
        if "B_SPLINE_SURFACE_WITH_KNOTS" in comps:
            return _build_rational_surface(ents, comps)
        raise ValueError(f"unsupported complex surface entity #{eid}")
    if e.type == "B_SPLINE_SURFACE_WITH_KNOTS":
        du, dv = int(e.args[1]), int(e.args[2])
        grid = np.array(
            [[ents[r].args[1] for r in row] for row in e.args[3]], float
        )
        mu, mv, ku, kv = e.args[8], e.args[9], e.args[10], e.args[11]
        return BsplineSurface(du, dv, _knot_vector(ku, mu), _knot_vector(kv, mv), grid)
    if e.type == "PLANE":
        return analytic.Plane(_frame(ents, e.args[1]))
    if e.type == "CYLINDRICAL_SURFACE":
        return analytic.Cylinder(_frame(ents, e.args[1]), float(e.args[2]))
    if e.type == "CONICAL_SURFACE":
        return analytic.Cone(
            _frame(ents, e.args[1]), float(e.args[2]), float(e.args[3])
        )
    if e.type == "SPHERICAL_SURFACE":
        return analytic.Sphere(_frame(ents, e.args[1]), float(e.args[2]))
    if e.type == "TOROIDAL_SURFACE":
        return analytic.Torus(
            _frame(ents, e.args[1]), float(e.args[2]), float(e.args[3])
        )
    if e.type == "SURFACE_OF_LINEAR_EXTRUSION":
        from brepgen_tpu_torch.geometry import swept

        return swept.make_extruded(
            _build_curve(ents, e.args[1]), _vector(ents, e.args[2])
        )
    if e.type == "SURFACE_OF_REVOLUTION":
        from brepgen_tpu_torch.geometry import swept

        return swept.make_revolved(
            _build_curve(ents, e.args[1]), _axis1_frame(ents, e.args[2])
        )
    if e.type == "OFFSET_SURFACE":
        from brepgen_tpu_torch.geometry import swept

        return swept.make_offset(_build_surface(ents, e.args[1]), float(e.args[2]))
    if e.type == "RECTANGULAR_TRIMMED_SURFACE":
        # args: name, basis, u1, u2, v1, v2, usense, vsense
        from brepgen_tpu_torch.geometry import swept

        return swept.make_trimmed(
            _build_surface(ents, e.args[1]),
            float(e.args[2]), float(e.args[3]),
            float(e.args[4]), float(e.args[5]),
        )
    if e.type == "DEGENERATE_TOROIDAL_SURFACE":
        # apple/lemon torus (minor >= major): the parametric evaluation
        # is the standard torus formula, so reuse it
        return analytic.Torus(
            _frame(ents, e.args[1]), float(e.args[2]), float(e.args[3])
        )
    raise ValueError(f"unsupported surface entity {e.type}")


def load_brep(path: str) -> StepBrep:
    """Load the first MANIFOLD_SOLID_BREP (or closed/open shell) found."""
    ents = parse_step(path)

    shells = [e for e in ents.values() if e.type == "MANIFOLD_SOLID_BREP"]
    if shells:
        name = shells[0].args[0] if isinstance(shells[0].args[0], str) else ""
        shell = ents[shells[0].args[1]]
    else:
        cand = [e for e in ents.values() if e.type in ("CLOSED_SHELL", "OPEN_SHELL")]
        if not cand:
            raise ValueError(f"{path}: no B-rep shell found")
        name, shell = "", cand[0]

    # collect vertices/edges lazily, indexing by entity id
    vert_index: Dict[int, int] = {}
    vert_pos: List[np.ndarray] = []
    edge_index: Dict[int, int] = {}
    edges: List[StepEdge] = []

    def vertex(ref: int) -> int:
        if ref not in vert_index:
            vp = ents[ref]
            assert vp.type == "VERTEX_POINT", vp.type
            vert_index[ref] = len(vert_pos)
            vert_pos.append(np.asarray(ents[vp.args[1]].args[1], float))
        return vert_index[ref]

    def edge(ref: int) -> int:
        if ref not in edge_index:
            ec = ents[ref]
            assert ec.type == "EDGE_CURVE", ec.type
            curve = _build_curve(ents, ec.args[3])
            edge_index[ref] = len(edges)
            edges.append(StepEdge(vertex(ec.args[1]), vertex(ec.args[2]), curve))
        return edge_index[ref]

    faces: List[StepFace] = []
    for fref in shell.args[1]:
        fe = ents[fref]
        if fe.type not in ("ADVANCED_FACE", "FACE_SURFACE"):
            continue
        surface = _build_surface(ents, fe.args[2])
        bounds = []
        for bref in fe.args[1]:
            be = ents[bref]
            loop = ents[be.args[1]]
            chain = []
            for oeref in loop.args[1]:
                oe = ents[oeref]
                same = oe.args[4] == ".T."
                chain.append((edge(oe.args[3]), same))
            bounds.append((be.type == "FACE_OUTER_BOUND", chain))
        faces.append(StepFace(surface, bounds))

    return StepBrep(name, np.array(vert_pos), edges, faces)


def validate_solid(brep: StepBrep) -> Dict[str, object]:
    """Topological checks that the shell is a sewn solid.

    Returns a report dict; ``ok`` is True when every loop is a closed
    vertex chain and every edge is used by exactly two face bounds (the
    manifold condition the reference gets from OCC sewing,
    ``utils.py:934-946``).
    """
    edge_use = np.zeros(len(brep.edges), int)
    open_loops = 0
    for face in brep.faces:
        for _, chain in face.bounds:
            ends = []
            for ei, same in chain:
                e = brep.edges[ei]
                edge_use[ei] += 1
                ends.append((e.v_start, e.v_end) if same else (e.v_end, e.v_start))
            closed = all(
                ends[i][1] == ends[(i + 1) % len(ends)][0] for i in range(len(ends))
            )
            open_loops += not closed
    report = {
        "n_faces": len(brep.faces),
        "n_edges": len(brep.edges),
        "n_vertices": len(brep.vertices),
        "open_loops": open_loops,
        "edge_use_min": int(edge_use.min()) if len(edge_use) else 0,
        "edge_use_max": int(edge_use.max()) if len(edge_use) else 0,
    }
    report["ok"] = (
        len(brep.faces) > 0
        and open_loops == 0
        and len(edge_use) > 0
        and bool((edge_use == 2).all())
    )
    return report
