"""Native STEP (ISO 10303-21) writer: topological B-reps and loose geometry.

The reference exports solids through OCC's ``write_step_file``
(``sample.py:367``), whose output is an AP203 ``ADVANCED_BREP`` — trimmed
faces, edge loops, vertices, a closed shell, and a manifold solid, built by
``construct_brep`` (``utils.py:819-947``). ``write_step_brep`` emits that
same topology stack natively:

  CARTESIAN_POINT/VERTEX_POINT → B_SPLINE_CURVE_WITH_KNOTS/EDGE_CURVE →
  ORIENTED_EDGE → EDGE_LOOP → FACE_OUTER_BOUND/FACE_BOUND →
  ADVANCED_FACE (on B_SPLINE_SURFACE_WITH_KNOTS) → CLOSED_SHELL →
  MANIFOLD_SOLID_BREP → ADVANCED_BREP_SHAPE_REPRESENTATION

plus the AP203 product skeleton (PRODUCT .. SHAPE_DEFINITION_REPRESENTATION)
that CAD importers use to find the root shape. Adjacent faces reference the
SAME ``EDGE_CURVE``/``VERTEX_POINT`` entities, so the shell is genuinely
sewn, not a bag of loose faces.

``write_step`` (geometry-only ``GEOMETRIC_SET``) remains as the fallback
when the topology is too degenerate to form closed loops.

The port's own copy of ``brepgen_tpu/geometry/step_writer.py``, unchanged in behaviour.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from brepgen_tpu_torch.geometry.bspline import BsplineCurve, BsplineSurface, knots_with_multiplicity


def _fmt(x: float) -> str:
    return f"{float(x):.10g}"


class _StepFile:
    def __init__(self):
        self.entities: List[str] = []

    def add(self, text: str) -> int:
        self.entities.append(text)
        return len(self.entities)  # 1-based ids

    def ref(self, eid: int) -> str:
        return f"#{eid}"


def _cartesian_points(sf: _StepFile, pts: np.ndarray) -> List[int]:
    return [
        sf.add(f"CARTESIAN_POINT('',({_fmt(p[0])},{_fmt(p[1])},{_fmt(p[2])}))")
        for p in pts
    ]


def _surface_entity(sf: _StepFile, s: BsplineSurface) -> int:
    nu, nv, _ = s.control.shape
    ids = _cartesian_points(sf, s.control.reshape(-1, 3))
    rows = []
    for i in range(nu):
        rows.append("(" + ",".join(f"#{ids[i * nv + j]}" for j in range(nv)) + ")")
    grid = "(" + ",".join(rows) + ")"
    ku, mu = knots_with_multiplicity(s.knots_u)
    kv, mv = knots_with_multiplicity(s.knots_v)
    return sf.add(
        "B_SPLINE_SURFACE_WITH_KNOTS('',{du},{dv},{grid},.UNSPECIFIED.,.F.,.F.,.F.,"
        "({mu}),({mv}),({ku}),({kv}),.UNSPECIFIED.)".format(
            du=s.degree_u,
            dv=s.degree_v,
            grid=grid,
            mu=",".join(str(int(m)) for m in mu),
            mv=",".join(str(int(m)) for m in mv),
            ku=",".join(_fmt(k) for k in ku),
            kv=",".join(_fmt(k) for k in kv),
        )
    )


def _curve_entity(sf: _StepFile, c: BsplineCurve) -> int:
    ids = _cartesian_points(sf, c.control)
    pts = "(" + ",".join(f"#{i}" for i in ids) + ")"
    k, m = knots_with_multiplicity(c.knots)
    return sf.add(
        "B_SPLINE_CURVE_WITH_KNOTS('',{d},{pts},.UNSPECIFIED.,.F.,.F.,"
        "({m}),({k}),.UNSPECIFIED.)".format(
            d=c.degree,
            pts=pts,
            m=",".join(str(int(x)) for x in m),
            k=",".join(_fmt(x) for x in k),
        )
    )


def _geometry_context(sf: _StepFile) -> int:
    unit = sf.add("( LENGTH_UNIT() NAMED_UNIT(*) SI_UNIT(.MILLI.,.METRE.) )")
    ang = sf.add("( NAMED_UNIT(*) PLANE_ANGLE_UNIT() SI_UNIT($,.RADIAN.) )")
    solid_ang = sf.add("( NAMED_UNIT(*) SI_UNIT($,.STERADIAN.) SOLID_ANGLE_UNIT() )")
    unc = sf.add(
        f"UNCERTAINTY_MEASURE_WITH_UNIT(LENGTH_MEASURE(1.E-6),#{unit},"
        "'distance_accuracy_value','')"
    )
    return sf.add(
        "( GEOMETRIC_REPRESENTATION_CONTEXT(3) "
        f"GLOBAL_UNCERTAINTY_ASSIGNED_CONTEXT((#{unc})) "
        f"GLOBAL_UNIT_ASSIGNED_CONTEXT((#{unit},#{ang},#{solid_ang})) "
        "REPRESENTATION_CONTEXT('',' ') )"
    )


def _product_skeleton(sf: _StepFile, shape_rep: int, name: str) -> None:
    """Minimal AP203 product structure rooting the shape representation."""
    app = sf.add(
        "APPLICATION_CONTEXT('configuration controlled 3d designs of "
        "mechanical parts and assemblies')"
    )
    sf.add(
        "APPLICATION_PROTOCOL_DEFINITION('international standard',"
        f"'config_control_design',1994,#{app})"
    )
    pc = sf.add(f"PRODUCT_CONTEXT('',#{app},'mechanical')")
    prod = sf.add(f"PRODUCT('{name}','{name}','',(#{pc}))")
    sf.add(f"PRODUCT_RELATED_PRODUCT_CATEGORY('part','',(#{prod}))")
    pdf = sf.add(f"PRODUCT_DEFINITION_FORMATION('','',#{prod})")
    pdc = sf.add(f"PRODUCT_DEFINITION_CONTEXT('part definition',#{app},'design')")
    pd = sf.add(f"PRODUCT_DEFINITION('design','',#{pdf},#{pdc})")
    pds = sf.add(f"PRODUCT_DEFINITION_SHAPE('','',#{pd})")
    sf.add(f"SHAPE_DEFINITION_REPRESENTATION(#{pds},#{shape_rep})")


def _write_file(path: str, sf: _StepFile, name: str) -> None:
    lines = [
        "ISO-10303-21;",
        "HEADER;",
        "FILE_DESCRIPTION(('BrepGen-TPU generated B-rep'),'2;1');",
        f"FILE_NAME('{name}.step','',('brepgen_tpu'),(''),'brepgen_tpu','','');",
        "FILE_SCHEMA(('CONFIG_CONTROL_DESIGN'));",
        "ENDSEC;",
        "DATA;",
    ]
    for i, e in enumerate(sf.entities, start=1):
        lines.append(f"#{i}={e};")
    lines += ["ENDSEC;", "END-ISO-10303-21;"]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def write_step(
    path: str,
    surfaces: List[BsplineSurface],
    curves: List[BsplineCurve],
    name: str = "brepgen_solid",
) -> None:
    """Geometry-only export: loose surfaces/curves in a GEOMETRIC_SET."""
    sf = _StepFile()
    ctx = _geometry_context(sf)
    geo_ids = [_surface_entity(sf, s) for s in surfaces]
    geo_ids += [_curve_entity(sf, c) for c in curves]
    gset = sf.add(
        "GEOMETRIC_SET('{n}',({ids}))".format(
            n=name, ids=",".join(f"#{i}" for i in geo_ids)
        )
    )
    rep = sf.add(
        f"GEOMETRICALLY_BOUNDED_SURFACE_SHAPE_REPRESENTATION('{name}',(#{gset}),#{ctx})"
    )
    _product_skeleton(sf, rep, name)
    _write_file(path, sf, name)


def _coherent_face_flips(
    face_loops, free_edges=frozenset()
) -> Tuple[List[bool], List[int]]:
    """Per-face flip flags making the shell's edge traversals coherent.

    A closed 2-manifold shell must traverse every shared edge ONCE IN EACH
    direction across its two adjacent faces (ISO 10303-42; OCC's sewing
    enforces this in the reference, ``utils.py:934-946`` — caught here by
    the independent conformance validator, ``step_conformance.py``). The
    UV-space loop orientation (``orient_loops_uv``) is per-face and knows
    nothing about neighbors, so propagate a global orientation: 2-color
    the face graph where an edge shared by faces f,g with stored
    traversal directions t_f,t_g imposes flip_f XOR flip_g == (t_f==t_g).

    ``free_edges`` are edge ids whose traversal direction carries no
    constraint — closed edges (start vertex == end vertex, e.g. full
    circles), whose ORIENTED_EDGE flag the writer can toggle locally
    without breaking any loop chain. They are left out of the constraint
    graph so a degenerate direction resolution on them cannot frustrate
    the coloring of the rest of the shell.

    Returns ``(flips, conflicts)``: ``conflicts`` lists the non-free edge
    ids whose two traversals remain same-direction under the best
    2-coloring — i.e. the recorded topology is non-orientable (e.g.
    several faces glued along the same boundary) and NO assignment of
    whole-face flips can make the shell coherent. Callers should treat a
    non-empty list as "not exportable as a MANIFOLD_SOLID_BREP".
    """
    uses: Dict[int, List[Tuple[int, bool]]] = {}
    for f, loops in enumerate(face_loops):
        for loop in loops:
            for e, fwd in loop:
                uses.setdefault(int(e), []).append((f, bool(fwd)))
    n = len(face_loops)
    adj: List[List[Tuple[int, bool, int]]] = [[] for _ in range(n)]
    conflicts = set()
    for e, us in uses.items():
        if len(us) != 2 or e in free_edges:
            continue
        (f, tf), (g, tg) = us
        if f == g:
            # both uses inside one face: a flip cannot change parity. A
            # proper seam traverses the edge once each way; same-direction
            # is a genuine topology defect.
            if tf == tg:
                conflicts.add(e)
            continue
        parity = tf == tg
        adj[f].append((g, parity, e))
        adj[g].append((f, parity, e))
    flips = [None] * n
    for root in range(n):
        if flips[root] is not None:
            continue
        flips[root] = False
        queue = [root]
        while queue:
            f = queue.pop()
            for g, parity, e in adj[f]:
                want = flips[f] ^ parity
                if flips[g] is None:
                    flips[g] = want
                    queue.append(g)
                elif flips[g] != want:
                    conflicts.add(e)  # odd cycle: non-orientable input
    return [bool(x) for x in flips], sorted(conflicts)


def write_step_brep(
    path: str,
    surfaces: List[BsplineSurface],          # per face
    curves: List[BsplineCurve],              # per global edge id
    face_loops: Sequence[Sequence[Sequence]],  # per face: loops of (edge_id, forward), outer first
    vertices: np.ndarray,                    # [V, 3] unique vertex positions
    edge_vertex_adj: np.ndarray,             # [E, 2] vertex ids per edge
    name: str = "brepgen_solid",
) -> List[int]:
    """Topological export: trimmed faces sewn into a MANIFOLD_SOLID_BREP.

    ``face_loops`` must come from ``order_loops``/``orient_loops_uv`` — each
    loop a closed chain of (edge_id, forward) with the outer bound first.
    ``forward`` means traversal from ``edge_vertex_adj[e][0]`` to ``[1]``.
    Edge-curve direction is resolved geometrically (the post-processor's
    lexsort canonicalization may store vertex pairs against the curve's
    sampling direction, ref ``dataset.py:522-525``).

    Returns the (normally empty) list of orientation-conflict edge ids
    from ``_coherent_face_flips`` — non-empty means the input topology is
    non-orientable and the emitted shell will fail the 2-manifold
    traversal check. ``SolidMesh.topology_ok`` screens for this before
    calling, so production exports never hit it.
    """
    sf = _StepFile()
    ctx = _geometry_context(sf)
    vertices = np.asarray(vertices, float)
    edge_vertex_adj = np.asarray(edge_vertex_adj, int)

    vert_pt = _cartesian_points(sf, vertices)
    vert_ent = [sf.add(f"VERTEX_POINT('',#{p})") for p in vert_pt]

    used_edges = sorted(
        {int(e) for loops in face_loops for loop in loops for e, _ in loop}
    )
    edge_ent = {}
    geo_fwd = {}
    for e in used_edges:
        c = curves[e]
        a, b = edge_vertex_adj[e]
        d0 = np.linalg.norm(c.control[0] - vertices[a])
        d1 = np.linalg.norm(c.control[0] - vertices[b])
        fwd = bool(d0 <= d1)  # curve's sampled start sits at vertex a
        geo_fwd[e] = fwd
        cid = _curve_entity(sf, c)
        vs, ve = (a, b) if fwd else (b, a)
        edge_ent[e] = sf.add(
            f"EDGE_CURVE('',#{vert_ent[vs]},#{vert_ent[ve]},#{cid},.T.)"
        )

    # shell-coherent orientation: flipped faces reverse their loops and
    # carry same_sense=.F. so the face normal (loop x surface) is preserved.
    # Closed edges (start vertex == end vertex) are excluded from the
    # constraint graph: their ORIENTED_EDGE flag carries no chain
    # information, so after the face flips are applied the second of their
    # two traversals is simply toggled to the opposite direction.
    closed_edges = frozenset(
        e for e in used_edges if edge_vertex_adj[e][0] == edge_vertex_adj[e][1]
    )
    flips, conflicts = _coherent_face_flips(face_loops, closed_edges)

    # first pass: resolve every traversal flag (mutable: [edge, flag])
    resolved = []
    closed_uses: Dict[int, List[List]] = {}
    for f, loops in enumerate(face_loops):
        rloops = []
        for loop in loops:
            loop = list(loop)
            if flips[f]:
                loop = [(e, not fwd) for e, fwd in reversed(loop)]
            entries = []
            for e, forward in loop:
                e = int(e)
                a, b = edge_vertex_adj[e]
                trav_start = a if forward else b
                ec_start = a if geo_fwd[e] else b
                entry = [e, trav_start == ec_start]
                entries.append(entry)
                if e in closed_edges:
                    closed_uses.setdefault(e, []).append(entry)
            rloops.append(entries)
        resolved.append(rloops)
    for us in closed_uses.values():
        if len(us) == 2 and us[0][1] == us[1][1]:
            us[1][1] = not us[1][1]

    face_ids = []
    for f, rloops in enumerate(resolved):
        sid = _surface_entity(sf, surfaces[f])
        bound_ids = []
        for li, entries in enumerate(rloops):
            oes = []
            for e, flag_fwd in entries:
                flag = ".T." if flag_fwd else ".F."
                oes.append(sf.add(f"ORIENTED_EDGE('',*,*,#{edge_ent[e]},{flag})"))
            elid = sf.add("EDGE_LOOP('',({}))".format(",".join(f"#{i}" for i in oes)))
            kind = "FACE_OUTER_BOUND" if li == 0 else "FACE_BOUND"
            bound_ids.append(sf.add(f"{kind}('',#{elid},.T.)"))
        sense = ".F." if flips[f] else ".T."
        face_ids.append(
            sf.add(
                "ADVANCED_FACE('',({}),#{},{})".format(
                    ",".join(f"#{i}" for i in bound_ids), sid, sense
                )
            )
        )

    shell = sf.add(
        "CLOSED_SHELL('',({}))".format(",".join(f"#{i}" for i in face_ids))
    )
    brep = sf.add(f"MANIFOLD_SOLID_BREP('{name}',#{shell})")
    org = sf.add("CARTESIAN_POINT('',(0.,0.,0.))")
    dz = sf.add("DIRECTION('',(0.,0.,1.))")
    dx = sf.add("DIRECTION('',(1.,0.,0.))")
    ax = sf.add(f"AXIS2_PLACEMENT_3D('',#{org},#{dz},#{dx})")
    rep = sf.add(
        f"ADVANCED_BREP_SHAPE_REPRESENTATION('{name}',(#{ax},#{brep}),#{ctx})"
    )
    _product_skeleton(sf, rep, name)
    _write_file(path, sf, name)
    return conflicts
