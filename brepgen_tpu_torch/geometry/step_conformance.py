"""Independent STEP (ISO 10303-21 / AP203 subset) conformance validator.

Exports validated only by this package's own ``step_reader`` would be a
self-referential check (a shared misunderstanding of the STEP schema
between writer and reader would pass silently). This module shares NO
code, tables, or parsing logic with ``step_writer.py`` or
``step_reader.py``: it re-derives the Part-21 exchange-structure rules and
the AP203 entity grammar for the subset the reference pipeline emits via
OpenCASCADE (reference ``utils.py:819-947``, STEP written at
``sample.py:367``), and checks

  1. Part-21 structure: header sections, record syntax, unique ids;
  2. entity grammar: every entity's argument count/kinds against an
     explicit AP203 signature table (strings, enums, refs, lists, ...);
  3. referential integrity: every ``#id`` resolves AND points at an
     entity type the grammar allows in that slot;
  4. B-spline laws: per direction, ``sum(mults) == n_poles + degree + 1``,
     strictly increasing knots, control-net shape consistency;
  5. topology (per MANIFOLD_SOLID_BREP): every face has exactly one
     FACE_OUTER_BOUND; every EDGE_LOOP is a closed vertex-connected chain
     of ORIENTED_EDGEs (orientation-resolved endpoints); the CLOSED_SHELL
     is 2-manifold — every EDGE_CURVE is used by exactly two oriented
     edges with OPPOSITE orientation flags; vertex sharing is by entity
     reference, not coordinate coincidence;
  6. geometry/topology agreement: each edge curve's clamped endpoints lie
     on its claimed start/end VERTEX_POINTs (within ``tol``).

``validate_step_file`` returns a list of human-readable violations
(empty == conformant). Runs on the pure-python stdlib + numpy — usable
in CI against every demo export.

The port's own copy of ``brepgen_tpu/geometry/step_conformance.py``; it
shares no code with the port's ``step_writer`` or ``step_reader`` either.
Run it on files: ``python -m brepgen_tpu_torch.geometry.step_conformance
FILE [FILE ...]`` (exit 1 when any file has a violation).
"""

from __future__ import annotations

import math
import re
import sys
from typing import Dict, List, Optional, Tuple

__all__ = ["validate_step_file", "validate_step_text"]


# ---------------------------------------------------------------------------
# Part-21 lexing: split the DATA section into records, respecting strings
# ---------------------------------------------------------------------------


def _split_records(data: str) -> List[str]:
    """Split on ';' outside of '...' strings (Part-21 '' escapes)."""
    out, buf, in_str, i = [], [], False, 0
    while i < len(data):
        ch = data[i]
        if in_str:
            buf.append(ch)
            if ch == "'":
                if i + 1 < len(data) and data[i + 1] == "'":
                    buf.append("'")
                    i += 1
                else:
                    in_str = False
        elif ch == "'":
            in_str = True
            buf.append(ch)
        elif ch == ";":
            rec = "".join(buf).strip()
            if rec:
                out.append(rec)
            buf = []
        else:
            buf.append(ch)
        i += 1
    tail = "".join(buf).strip()
    if tail:
        out.append(tail)
    return out


class _Tok:
    """Token stream over one record body."""

    _PAT = re.compile(
        r"\s*(?:"
        r"(?P<str>'(?:[^']|'')*')"
        r"|(?P<ref>#\d+)"
        r"|(?P<enum>\.[A-Z_0-9]+\.)"
        r"|(?P<num>[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?)"
        r"|(?P<name>[A-Z_][A-Z_0-9]*)"
        r"|(?P<punct>[(),*$])"
        r")"
    )

    def __init__(self, text: str):
        self.toks: List[Tuple[str, str]] = []
        pos = 0
        while pos < len(text):
            m = self._PAT.match(text, pos)
            if not m:
                if text[pos:].strip():
                    raise ValueError(f"lex error at ...{text[pos:pos+40]!r}")
                break
            pos = m.end()
            for kind in ("str", "ref", "enum", "num", "name", "punct"):
                v = m.group(kind)
                if v is not None:
                    self.toks.append((kind, v))
                    break
        self.i = 0

    def peek(self) -> Optional[Tuple[str, str]]:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self) -> Tuple[str, str]:
        t = self.peek()
        if t is None:
            raise ValueError("unexpected end of record")
        self.i += 1
        return t


# value model: ("str", s) ("ref", int) ("enum", ".T.") ("num", float)
# ("list", [...]) ("star",) ("dollar",) ("typed", NAME, [args])
def _parse_value(tk: _Tok):
    kind, v = tk.next()
    if kind == "str":
        return ("str", v[1:-1].replace("''", "'"))
    if kind == "ref":
        return ("ref", int(v[1:]))
    if kind == "enum":
        return ("enum", v)
    if kind == "num":
        return ("num", float(v))
    if kind == "name":
        nxt = tk.peek()
        if nxt != ("punct", "("):
            raise ValueError(f"bare name {v} without args")
        tk.next()
        return ("typed", v, _parse_args(tk))
    if kind == "punct" and v == "(":
        return ("list", _parse_args(tk))
    if kind == "punct" and v == "*":
        return ("star",)
    if kind == "punct" and v == "$":
        return ("dollar",)
    raise ValueError(f"unexpected token {kind}:{v}")


def _parse_args(tk: _Tok) -> list:
    """Parse a comma-separated value list up to the closing ')'."""
    args = []
    nxt = tk.peek()
    if nxt == ("punct", ")"):
        tk.next()
        return args
    while True:
        args.append(_parse_value(tk))
        kind, v = tk.next()
        if (kind, v) == ("punct", ")"):
            return args
        if (kind, v) != ("punct", ","):
            raise ValueError(f"expected ',' or ')', got {v}")


def _parse_record_body(body: str):
    """'TYPE(args)' or complex '( T1(a) T2(b) ... )' -> parsed entity."""
    tk = _Tok(body)
    kind, v = tk.next()
    if kind == "name":
        if tk.next() != ("punct", "("):
            raise ValueError(f"entity {v}: missing '('")
        ent = ("typed", v, _parse_args(tk))
    elif (kind, v) == ("punct", "("):
        parts = []
        while True:
            nxt = tk.peek()
            if nxt == ("punct", ")"):
                tk.next()
                break
            k2, v2 = tk.next()
            if k2 != "name":
                raise ValueError(f"complex entity: expected name, got {v2}")
            if tk.next() != ("punct", "("):
                raise ValueError(f"complex part {v2}: missing '('")
            parts.append(("typed", v2, _parse_args(tk)))
        ent = ("complex", parts)
    else:
        raise ValueError(f"record must start with a name or '(', got {v}")
    if tk.peek() is not None:
        raise ValueError("trailing tokens after entity")
    return ent


# ---------------------------------------------------------------------------
# AP203 grammar for the emitted subset
# ---------------------------------------------------------------------------

_CURVES = "B_SPLINE_CURVE_WITH_KNOTS|LINE|CIRCLE|ELLIPSE|TRIMMED_CURVE"
_SURFACES = "B_SPLINE_SURFACE_WITH_KNOTS|PLANE|CYLINDRICAL_SURFACE"
_BOUNDS = "FACE_OUTER_BOUND|FACE_BOUND"

# spec atoms: str num int bool enum star ref:T1|T2 list[...] opt(...)=\
#   '?'-prefixed (allows $), 'any'
GRAMMAR: Dict[str, List[str]] = {
    "CARTESIAN_POINT": ["str", "list[num]"],
    "DIRECTION": ["str", "list[num]"],
    "AXIS2_PLACEMENT_3D": [
        "str", "ref:CARTESIAN_POINT", "?ref:DIRECTION", "?ref:DIRECTION"],
    "VERTEX_POINT": ["str", "ref:CARTESIAN_POINT"],
    "B_SPLINE_CURVE_WITH_KNOTS": [
        "str", "int", "list[ref:CARTESIAN_POINT]", "enum", "bool", "bool",
        "list[int]", "list[num]", "enum"],
    "B_SPLINE_SURFACE_WITH_KNOTS": [
        "str", "int", "int", "list[list[ref:CARTESIAN_POINT]]", "enum",
        "bool", "bool", "bool", "list[int]", "list[int]", "list[num]",
        "list[num]", "enum"],
    "EDGE_CURVE": [
        "str", "ref:VERTEX_POINT", "ref:VERTEX_POINT", f"ref:{_CURVES}",
        "bool"],
    "ORIENTED_EDGE": ["str", "star", "star", "ref:EDGE_CURVE", "bool"],
    "EDGE_LOOP": ["str", "list[ref:ORIENTED_EDGE]"],
    "FACE_OUTER_BOUND": ["str", "ref:EDGE_LOOP", "bool"],
    "FACE_BOUND": ["str", "ref:EDGE_LOOP", "bool"],
    "ADVANCED_FACE": [
        "str", f"list[ref:{_BOUNDS}]", f"ref:{_SURFACES}", "bool"],
    "CLOSED_SHELL": ["str", "list[ref:ADVANCED_FACE]"],
    "MANIFOLD_SOLID_BREP": ["str", "ref:CLOSED_SHELL"],
    "ADVANCED_BREP_SHAPE_REPRESENTATION": [
        "str", "list[ref:AXIS2_PLACEMENT_3D|MANIFOLD_SOLID_BREP]",
        "ref:<complex>"],
    "UNCERTAINTY_MEASURE_WITH_UNIT": [
        "typed:LENGTH_MEASURE", "ref:<complex>", "str", "str"],
    "APPLICATION_CONTEXT": ["str"],
    "APPLICATION_PROTOCOL_DEFINITION": [
        "str", "str", "int", "ref:APPLICATION_CONTEXT"],
    "PRODUCT_CONTEXT": ["str", "ref:APPLICATION_CONTEXT", "str"],
    "PRODUCT": ["str", "str", "str", "list[ref:PRODUCT_CONTEXT]"],
    "PRODUCT_RELATED_PRODUCT_CATEGORY": ["str", "?str", "list[ref:PRODUCT]"],
    "PRODUCT_DEFINITION_FORMATION": ["str", "str", "ref:PRODUCT"],
    "PRODUCT_DEFINITION_CONTEXT": [
        "str", "ref:APPLICATION_CONTEXT", "str"],
    "PRODUCT_DEFINITION": [
        "str", "str", "ref:PRODUCT_DEFINITION_FORMATION",
        "ref:PRODUCT_DEFINITION_CONTEXT"],
    "PRODUCT_DEFINITION_SHAPE": ["str", "str", "ref:PRODUCT_DEFINITION"],
    "SHAPE_DEFINITION_REPRESENTATION": [
        "ref:PRODUCT_DEFINITION_SHAPE",
        "ref:ADVANCED_BREP_SHAPE_REPRESENTATION"
        "|GEOMETRICALLY_BOUNDED_SURFACE_SHAPE_REPRESENTATION"],
    # geometry-only fallback
    "GEOMETRIC_SET": ["str", f"list[ref:{_CURVES}|{_SURFACES}]"],
    "GEOMETRICALLY_BOUNDED_SURFACE_SHAPE_REPRESENTATION": [
        "str", "list[ref:GEOMETRIC_SET]", "ref:<complex>"],
}

# complex-entity component names we accept (units / representation context)
_COMPLEX_OK = {
    "LENGTH_UNIT", "NAMED_UNIT", "SI_UNIT", "PLANE_ANGLE_UNIT",
    "SOLID_ANGLE_UNIT", "GEOMETRIC_REPRESENTATION_CONTEXT",
    "GLOBAL_UNCERTAINTY_ASSIGNED_CONTEXT", "GLOBAL_UNIT_ASSIGNED_CONTEXT",
    "REPRESENTATION_CONTEXT",
}


def _ent_type(ent) -> str:
    return ent[1] if ent[0] == "typed" else "<complex>"


def _check_spec(val, spec: str, ents, errs, ctx: str) -> None:
    if spec.startswith("?"):
        if val == ("dollar",):
            return
        spec = spec[1:]
    if spec == "any":
        return
    if spec == "str":
        if val[0] != "str":
            errs.append(f"{ctx}: expected string, got {val[0]}")
    elif spec == "num":
        if val[0] != "num":
            errs.append(f"{ctx}: expected number, got {val[0]}")
    elif spec == "int":
        if val[0] != "num" or val[1] != int(val[1]):
            errs.append(f"{ctx}: expected integer, got {val}")
    elif spec == "bool":
        if val[0] != "enum" or val[1] not in (".T.", ".F."):
            errs.append(f"{ctx}: expected .T./.F., got {val}")
    elif spec == "enum":
        if val[0] != "enum":
            errs.append(f"{ctx}: expected enum, got {val[0]}")
    elif spec == "star":
        if val[0] != "star":
            errs.append(f"{ctx}: expected '*', got {val[0]}")
    elif spec.startswith("typed:"):
        if val[0] != "typed" or val[1] != spec[6:]:
            errs.append(f"{ctx}: expected {spec[6:]}(...), got {val[:2]}")
    elif spec.startswith("ref:"):
        if val[0] != "ref":
            errs.append(f"{ctx}: expected #ref, got {val[0]}")
            return
        target = ents.get(val[1])
        if target is None:
            errs.append(f"{ctx}: dangling reference #{val[1]}")
            return
        allowed = spec[4:].split("|")
        if _ent_type(target) not in allowed:
            errs.append(
                f"{ctx}: #{val[1]} is {_ent_type(target)}, expected "
                f"{' or '.join(allowed)}")
    elif spec.startswith("list["):
        inner = spec[5:-1]
        if val[0] != "list":
            errs.append(f"{ctx}: expected list, got {val[0]}")
            return
        for j, item in enumerate(val[1]):
            _check_spec(item, inner, ents, errs, f"{ctx}[{j}]")
    else:  # pragma: no cover - grammar typo guard
        raise AssertionError(f"bad spec {spec}")


# ---------------------------------------------------------------------------
# Topology + B-spline + geometry checks
# ---------------------------------------------------------------------------


def _bspline_checks(eid, ent, errs) -> None:
    name = ent[1]
    args = ent[2]
    try:
        if name == "B_SPLINE_CURVE_WITH_KNOTS":
            deg = int(args[1][1])
            n_ctrl = len(args[2][1])
            mults = [int(v[1]) for v in args[6][1]]
            knots = [v[1] for v in args[7][1]]
            dirs = [(deg, n_ctrl, mults, knots, "")]
        else:
            du, dv = int(args[1][1]), int(args[2][1])
            grid = args[3][1]
            rows = len(grid)
            cols = len(grid[0][1]) if rows else 0
            for r in grid:
                if len(r[1]) != cols:
                    errs.append(f"#{eid} {name}: ragged control grid")
            dirs = [
                (du, rows, [int(v[1]) for v in args[8][1]],
                 [v[1] for v in args[10][1]], " (u)"),
                (dv, cols, [int(v[1]) for v in args[9][1]],
                 [v[1] for v in args[11][1]], " (v)"),
            ]
    except (IndexError, TypeError):
        return  # grammar check already reported malformed args
    for deg, n_ctrl, mults, knots, tag in dirs:
        if deg < 1:
            errs.append(f"#{eid} {name}{tag}: degree {deg} < 1")
        if len(mults) != len(knots):
            errs.append(f"#{eid} {name}{tag}: {len(mults)} multiplicities "
                        f"vs {len(knots)} knots")
            continue
        if sum(mults) != n_ctrl + deg + 1:
            errs.append(
                f"#{eid} {name}{tag}: knot law violated — sum(mults)="
                f"{sum(mults)} != poles+degree+1={n_ctrl + deg + 1}")
        if any(b <= a for a, b in zip(knots, knots[1:])):
            errs.append(f"#{eid} {name}{tag}: knots not strictly increasing")


def _point_of(ents, vertex_ref: int) -> Optional[List[float]]:
    vp = ents.get(vertex_ref)
    if vp is None or vp[0] != "typed" or vp[1] != "VERTEX_POINT":
        return None
    cp = ents.get(vp[2][1][1]) if vp[2][1][0] == "ref" else None
    if cp is None or cp[1] != "CARTESIAN_POINT":
        return None
    return [v[1] for v in cp[2][1][1]]


def _curve_endpoints(ents, curve_ref: int):
    """Clamped B-spline endpoints = first/last control point (only when
    end multiplicities equal degree+1; otherwise returns None)."""
    c = ents.get(curve_ref)
    if c is None or c[0] != "typed" or c[1] != "B_SPLINE_CURVE_WITH_KNOTS":
        return None
    deg = int(c[2][1][1])
    ctrl_refs = [v[1] for v in c[2][2][1] if v[0] == "ref"]
    mults = [int(v[1]) for v in c[2][6][1]]
    if len(ctrl_refs) < 2 or not mults:
        return None
    if mults[0] != deg + 1 or mults[-1] != deg + 1:
        return None  # unclamped: endpoint != control point; skip
    def pt(ref):
        cp = ents.get(ref)
        if cp is None or cp[1] != "CARTESIAN_POINT":
            return None
        return [v[1] for v in cp[2][1][1]]
    return pt(ctrl_refs[0]), pt(ctrl_refs[-1])


def _dist(a, b) -> float:
    return math.sqrt(sum((x - y) ** 2 for x, y in zip(a, b)))


def _topology_checks(ents, errs, tol: float) -> None:
    for sid, ent in ents.items():
        if ent[0] != "typed" or ent[1] != "MANIFOLD_SOLID_BREP":
            continue
        shell = ents.get(ent[2][1][1])
        if shell is None:
            continue
        face_refs = [v[1] for v in shell[2][1][1] if v[0] == "ref"]
        if not face_refs:
            errs.append(f"#{sid} MANIFOLD_SOLID_BREP: empty shell")
            continue
        # edge usage across the whole shell: (edge_curve_id -> [flags])
        edge_use: Dict[int, List[bool]] = {}
        for fref in face_refs:
            face = ents.get(fref)
            if face is None:
                continue
            bound_refs = [v[1] for v in face[2][1][1] if v[0] == "ref"]
            outer = [b for b in bound_refs
                     if _ent_type(ents.get(b, ("x",))) == "FACE_OUTER_BOUND"]
            if len(outer) != 1:
                errs.append(f"face #{fref}: {len(outer)} FACE_OUTER_BOUNDs "
                            "(must be exactly 1)")
            for bref in bound_refs:
                bound = ents.get(bref)
                if bound is None:
                    continue
                loop = ents.get(bound[2][1][1])
                if loop is None or _ent_type(loop) != "EDGE_LOOP":
                    continue
                oe_refs = [v[1] for v in loop[2][1][1] if v[0] == "ref"]
                if not oe_refs:
                    errs.append(f"loop #{bound[2][1][1]}: empty EDGE_LOOP")
                    continue
                chain = []
                for oref in oe_refs:
                    oe = ents.get(oref)
                    if oe is None or _ent_type(oe) != "ORIENTED_EDGE":
                        chain = None
                        break
                    ec_ref = oe[2][3][1]
                    fwd = oe[2][4][1] == ".T."
                    ec = ents.get(ec_ref)
                    if ec is None or _ent_type(ec) != "EDGE_CURVE":
                        chain = None
                        break
                    v1, v2 = ec[2][1][1], ec[2][2][1]
                    start, end = (v1, v2) if fwd else (v2, v1)
                    chain.append((ec_ref, start, end))
                    edge_use.setdefault(ec_ref, []).append(fwd)
                if chain is None:
                    continue
                for k in range(len(chain)):
                    _, _, end = chain[k]
                    _, nxt_start, _ = chain[(k + 1) % len(chain)]
                    if end != nxt_start:
                        errs.append(
                            f"loop in face #{fref}: edge #{chain[k][0]} ends "
                            f"at vertex #{end} but next edge starts at "
                            f"#{nxt_start} — wire not vertex-connected")
        for ec_ref, flags in edge_use.items():
            if len(flags) != 2:
                errs.append(
                    f"shell of #{sid}: EDGE_CURVE #{ec_ref} used "
                    f"{len(flags)}x (a closed 2-manifold shell uses every "
                    "edge exactly twice)")
            elif flags[0] == flags[1]:
                errs.append(
                    f"shell of #{sid}: EDGE_CURVE #{ec_ref} traversed twice "
                    "in the SAME direction (neighboring faces must traverse "
                    "a shared edge oppositely)")
        # geometry <-> topology agreement
        for ec_ref in edge_use:
            ec = ents[ec_ref]
            ends = _curve_endpoints(ents, ec[2][3][1])
            if ends is None or ends[0] is None or ends[1] is None:
                continue
            same_sense = ec[2][4][1] == ".T."
            c0, c1 = ends if same_sense else ends[::-1]
            pv1 = _point_of(ents, ec[2][1][1])
            pv2 = _point_of(ents, ec[2][2][1])
            if pv1 is None or pv2 is None:
                continue
            d = max(_dist(c0, pv1), _dist(c1, pv2))
            if d > tol:
                errs.append(
                    f"EDGE_CURVE #{ec_ref}: curve endpoints deviate "
                    f"{d:.4g} from claimed vertices (tol {tol})")


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def validate_step_text(text: str, tol: float = 0.1) -> List[str]:
    errs: List[str] = []
    # 1. Part-21 envelope
    records = _split_records(text)
    if not records or records[0] != "ISO-10303-21":
        errs.append("file does not start with 'ISO-10303-21;'")
    if not records or records[-1] != "END-ISO-10303-21":
        errs.append("file does not end with 'END-ISO-10303-21;'")
    try:
        h0 = records.index("HEADER")
        h1 = records.index("ENDSEC")
        header = records[h0 + 1:h1]
        d0 = records.index("DATA")
        d1 = records.index("ENDSEC", d0)
        data = records[d0 + 1:d1]
    except ValueError:
        errs.append("missing HEADER/DATA/ENDSEC section structure")
        return errs
    if not any(r.startswith("FILE_SCHEMA") for r in header):
        errs.append("header missing FILE_SCHEMA")
    if not any(r.startswith("FILE_DESCRIPTION") for r in header):
        errs.append("header missing FILE_DESCRIPTION")
    if not any(r.startswith("FILE_NAME") for r in header):
        errs.append("header missing FILE_NAME")

    # 2. parse records
    ents: Dict[int, tuple] = {}
    rec_pat = re.compile(r"#(\d+)\s*=\s*(.*)", re.S)
    for rec in data:
        m = rec_pat.match(rec)
        if not m:
            errs.append(f"malformed data record: {rec[:60]!r}")
            continue
        eid = int(m.group(1))
        if eid in ents:
            errs.append(f"duplicate entity id #{eid}")
        try:
            ents[eid] = _parse_record_body(m.group(2))
        except ValueError as e:
            errs.append(f"#{eid}: {e}")

    # 3. grammar + referential integrity
    for eid, ent in sorted(ents.items()):
        if ent[0] == "complex":
            for part in ent[1]:
                if part[1] not in _COMPLEX_OK:
                    errs.append(
                        f"#{eid}: unknown complex component {part[1]}")
                for a in part[2]:
                    if a[0] == "ref" and a[1] not in ents:
                        errs.append(f"#{eid}: dangling reference #{a[1]}")
            continue
        name, args = ent[1], ent[2]
        spec = GRAMMAR.get(name)
        if spec is None:
            errs.append(f"#{eid}: entity type {name} outside the AP203 "
                        "subset this pipeline emits")
            continue
        if len(args) != len(spec):
            errs.append(f"#{eid} {name}: {len(args)} args, expected "
                        f"{len(spec)}")
            continue
        for k, (val, sp) in enumerate(zip(args, spec)):
            _check_spec(val, sp, ents, errs, f"#{eid} {name} arg{k}")
        if name in ("B_SPLINE_CURVE_WITH_KNOTS",
                    "B_SPLINE_SURFACE_WITH_KNOTS"):
            _bspline_checks(eid, ent, errs)
        if name in ("CARTESIAN_POINT", "DIRECTION"):
            coords = args[1][1] if args[1][0] == "list" else []
            if len(coords) != 3:
                errs.append(f"#{eid} {name}: {len(coords)} coords, "
                            "expected 3")
            if any(v[0] != "num" or not math.isfinite(v[1])
                   for v in coords):
                errs.append(f"#{eid} {name}: non-finite coordinate")

    # 4. topology + geometry agreement
    _topology_checks(ents, errs, tol)
    return errs


def validate_step_file(path: str, tol: float = 0.1) -> List[str]:
    with open(path) as f:
        return validate_step_text(f.read(), tol=tol)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("usage: python -m brepgen_tpu_torch.geometry.step_conformance "
              "<file.step> [...]")
        return 2
    bad = 0
    for path in argv:
        errs = validate_step_file(path)
        status = "CONFORMANT" if not errs else f"{len(errs)} violations"
        print(f"{path}: {status}")
        for e in errs[:50]:
            print(f"  - {e}")
        bad += bool(errs)
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
