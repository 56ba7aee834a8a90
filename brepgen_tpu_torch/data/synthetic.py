"""Analytic synthetic B-rep fixtures (cuboids, n-prisms, cylinders).

The port's own numpy copy of ``brepgen_tpu/data/synthetic.py``.

The reference extracts training data from STEP files via OpenCASCADE. This
module produces schema-identical samples analytically so the entire
pipeline (VAE + LDM training, the sampling cascade, post-processing,
B-rep assembly, and evaluation) runs end-to-end without a CAD kernel --
used for tests, CI, and smoke benchmarks. Real extraction lives in
the JAX package's ``geometry`` (OCC-backed when available).

Conventions match ``data_process/process_brep.py``: 32x32 UV grids per
face, 32-point u-grids per edge, mating topology (every edge borders
exactly 2 faces), solid normalized to [-1,1]^3.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from brepgen_tpu_torch.data.schema import build_brep_sample

N_GRID = 32


def _line(p0, p1, n=N_GRID):
    t = np.linspace(0.0, 1.0, n)[:, None]
    return (1 - t) * np.asarray(p0)[None] + t * np.asarray(p1)[None]


def _planar_grid(origin, eu, ev, n=N_GRID):
    u = np.linspace(0.0, 1.0, n)
    v = np.linspace(0.0, 1.0, n)
    return (
        np.asarray(origin)[None, None]
        + u[:, None, None] * np.asarray(eu)[None, None]
        + v[None, :, None] * np.asarray(ev)[None, None]
    )


class _Builder:
    """Accumulates vertices/edges/faces then emits a schema sample."""

    def __init__(self):
        self.verts: List[np.ndarray] = []
        self.edges: List[np.ndarray] = []       # [32, 3] point arrays
        self.edge_verts: List[tuple] = []       # (v_start, v_end) ids
        self.faces: List[np.ndarray] = []       # [32, 32, 3] grids
        self.face_edges: List[List[int]] = []

    def vertex(self, p) -> int:
        self.verts.append(np.asarray(p, float))
        return len(self.verts) - 1

    def edge(self, pts: np.ndarray, v0: int, v1: int) -> int:
        self.edges.append(np.asarray(pts, float))
        self.edge_verts.append((v0, v1))
        return len(self.edges) - 1

    def face(self, grid: np.ndarray, edge_ids: Sequence[int]) -> int:
        self.faces.append(np.asarray(grid, float))
        self.face_edges.append(list(edge_ids))
        return len(self.faces) - 1

    def build(self, uid: str) -> Dict:
        ne = len(self.edges)
        corner_pnts = np.stack(
            [np.stack([self.verts[a], self.verts[b]]) for a, b in self.edge_verts]
        )
        edgeFace = [[] for _ in range(ne)]
        for fi, eids in enumerate(self.face_edges):
            for e in eids:
                edgeFace[e].append(fi)
        for e, fs in enumerate(edgeFace):
            assert len(fs) == 2, f"edge {e} borders {len(fs)} faces (must be 2)"
        return build_brep_sample(
            self.faces,
            self.edges,
            corner_pnts,
            [np.array(e) for e in self.face_edges],
            np.array(edgeFace),
            uid,
        )


def make_cuboid(sx=1.0, sy=1.0, sz=1.0, uid="cuboid") -> Dict:
    b = _Builder()
    # vertices indexed by (x, y, z) in {0,1}^3
    vid = {}
    for ix in (0, 1):
        for iy in (0, 1):
            for iz in (0, 1):
                vid[(ix, iy, iz)] = b.vertex([ix * sx, iy * sy, iz * sz])

    eid = {}

    def add_edge(a, c):
        key = (a, c) if a < c else (c, a)
        if key not in eid:
            eid[key] = b.edge(_line(b.verts[vid[a]], b.verts[vid[c]]), vid[a], vid[c])
        return eid[key]

    # 6 faces: fix one axis at 0 or 1
    for axis in range(3):
        for side in (0, 1):
            corners = []
            for u in (0, 1):
                for v in (0, 1):
                    c = [0, 0, 0]
                    c[axis] = side
                    c[(axis + 1) % 3] = u
                    c[(axis + 2) % 3] = v
                    corners.append(tuple(c))
            c00, c01, c10, c11 = corners
            edges = [
                add_edge(c00, c01),
                add_edge(c00, c10),
                add_edge(c01, c11),
                add_edge(c10, c11),
            ]
            origin = np.array(c00, float) * [sx, sy, sz]
            eu = (np.array(c10, float) - np.array(c00, float)) * [sx, sy, sz]
            ev = (np.array(c01, float) - np.array(c00, float)) * [sx, sy, sz]
            b.face(_planar_grid(origin, eu, ev), edges)
    return b.build(uid)


def make_prism(n_sides=6, radius=1.0, height=1.0, uid="prism") -> Dict:
    """n-gon prism: 2 polygonal caps + n rectangular sides."""
    b = _Builder()
    theta = 2 * np.pi * np.arange(n_sides) / n_sides
    bot = [b.vertex([radius * np.cos(t), radius * np.sin(t), 0.0]) for t in theta]
    top = [b.vertex([radius * np.cos(t), radius * np.sin(t), height]) for t in theta]

    bot_e = [
        b.edge(_line(b.verts[bot[i]], b.verts[bot[(i + 1) % n_sides]]), bot[i], bot[(i + 1) % n_sides])
        for i in range(n_sides)
    ]
    top_e = [
        b.edge(_line(b.verts[top[i]], b.verts[top[(i + 1) % n_sides]]), top[i], top[(i + 1) % n_sides])
        for i in range(n_sides)
    ]
    vert_e = [b.edge(_line(b.verts[bot[i]], b.verts[top[i]]), bot[i], top[i]) for i in range(n_sides)]

    # caps: planar surface over the polygon's bbox square
    for z, edges in ((0.0, bot_e), (height, top_e)):
        b.face(
            _planar_grid([-radius, -radius, z], [2 * radius, 0, 0], [0, 2 * radius, 0]),
            edges,
        )
    # sides
    for i in range(n_sides):
        j = (i + 1) % n_sides
        origin = b.verts[bot[i]]
        eu = b.verts[bot[j]] - b.verts[bot[i]]
        ev = np.array([0.0, 0.0, height])
        b.face(_planar_grid(origin, eu, ev), [bot_e[i], top_e[i], vert_e[i], vert_e[j]])
    return b.build(uid)


def make_cylinder(radius=1.0, height=1.0, uid="cylinder") -> Dict:
    """Cylinder with closed side/cap curves split in half (the reference
    splits all closed faces/edges, ``process_brep.py:78-79``)."""
    b = _Builder()
    v = [
        b.vertex([radius, 0, 0.0]),
        b.vertex([-radius, 0, 0.0]),
        b.vertex([radius, 0, height]),
        b.vertex([-radius, 0, height]),
    ]

    def arc(z, t0, t1):
        t = np.linspace(t0, t1, N_GRID)
        return np.stack([radius * np.cos(t), radius * np.sin(t), np.full_like(t, z)], -1)

    bot_a = b.edge(arc(0, 0, np.pi), v[0], v[1])
    bot_b = b.edge(arc(0, np.pi, 2 * np.pi), v[1], v[0])
    top_a = b.edge(arc(height, 0, np.pi), v[2], v[3])
    top_b = b.edge(arc(height, np.pi, 2 * np.pi), v[3], v[2])
    seam0 = b.edge(_line(b.verts[v[0]], b.verts[v[2]]), v[0], v[2])
    seam1 = b.edge(_line(b.verts[v[1]], b.verts[v[3]]), v[1], v[3])

    def side_grid(t0, t1):
        t = np.linspace(t0, t1, N_GRID)
        z = np.linspace(0, height, N_GRID)
        return np.stack(
            [
                np.broadcast_to(radius * np.cos(t)[:, None], (N_GRID, N_GRID)),
                np.broadcast_to(radius * np.sin(t)[:, None], (N_GRID, N_GRID)),
                np.broadcast_to(z[None, :], (N_GRID, N_GRID)),
            ],
            -1,
        )

    b.face(side_grid(0, np.pi), [bot_a, top_a, seam0, seam1])
    b.face(side_grid(np.pi, 2 * np.pi), [bot_b, top_b, seam1, seam0])
    for z, ea, eb in ((0.0, bot_a, bot_b), (height, top_a, top_b)):
        b.face(
            _planar_grid([-radius, -radius, z], [2 * radius, 0, 0], [0, 2 * radius, 0]),
            [ea, eb],
        )
    return b.build(uid)


def make_lblock(sx=2.0, sy=2.0, sz=1.0, cx=1.0, cy=1.0, uid="lblock") -> Dict:
    """L-shaped extrusion: a concave hexagonal cross-section swept along z.

    8 faces (two 6-edge L-caps + six 4-edge rectangular sides), 18 edges.
    The concave outer wire and 6-edge loops are deliberately OUTSIDE the
    cuboid/prism/cylinder family the recovery ladder was tuned on
    (VERDICT r4 item 5: held-out-family generalization evidence). The
    notch removes the (+x, +y) corner: requires 0 < cx < sx, 0 < cy < sy.
    """
    assert 0 < cx < sx and 0 < cy < sy
    b = _Builder()
    # L polygon, counterclockwise
    poly = [(0.0, 0.0), (sx, 0.0), (sx, cy), (cx, cy), (cx, sy), (0.0, sy)]
    n = len(poly)
    bot = [b.vertex([x, y, 0.0]) for x, y in poly]
    top = [b.vertex([x, y, sz]) for x, y in poly]
    bot_e = [b.edge(_line(b.verts[bot[i]], b.verts[bot[(i + 1) % n]]),
                    bot[i], bot[(i + 1) % n]) for i in range(n)]
    top_e = [b.edge(_line(b.verts[top[i]], b.verts[top[(i + 1) % n]]),
                    top[i], top[(i + 1) % n]) for i in range(n)]
    vert_e = [b.edge(_line(b.verts[bot[i]], b.verts[top[i]]), bot[i], top[i])
              for i in range(n)]
    # caps: planar grid over the cross-section bbox (same convention as
    # make_prism caps -- trim is carried by the edge loop)
    for z, edges in ((0.0, bot_e), (sz, top_e)):
        b.face(_planar_grid([0.0, 0.0, z], [sx, 0, 0], [0, sy, 0]), edges)
    # sides
    for i in range(n):
        j = (i + 1) % n
        origin = b.verts[bot[i]]
        eu = b.verts[bot[j]] - b.verts[bot[i]]
        b.face(_planar_grid(origin, eu, [0.0, 0.0, sz]),
               [bot_e[i], top_e[i], vert_e[i], vert_e[j]])
    return b.build(uid)


def make_frustum(r_bot=1.0, r_top=0.5, height=1.0, uid="frustum") -> Dict:
    """Truncated cone (swept/revolution-style lateral surface), split in
    half like ``make_cylinder`` (reference splits closed faces/edges,
    ``process_brep.py:78-79``). Caps of DIFFERENT radii + conical sides:
    geometry outside the family the recovery ladder was tuned on."""
    b = _Builder()
    v = [
        b.vertex([r_bot, 0, 0.0]),
        b.vertex([-r_bot, 0, 0.0]),
        b.vertex([r_top, 0, height]),
        b.vertex([-r_top, 0, height]),
    ]

    def arc(z, r, t0, t1):
        t = np.linspace(t0, t1, N_GRID)
        return np.stack([r * np.cos(t), r * np.sin(t), np.full_like(t, z)], -1)

    bot_a = b.edge(arc(0, r_bot, 0, np.pi), v[0], v[1])
    bot_b = b.edge(arc(0, r_bot, np.pi, 2 * np.pi), v[1], v[0])
    top_a = b.edge(arc(height, r_top, 0, np.pi), v[2], v[3])
    top_b = b.edge(arc(height, r_top, np.pi, 2 * np.pi), v[3], v[2])
    seam0 = b.edge(_line(b.verts[v[0]], b.verts[v[2]]), v[0], v[2])
    seam1 = b.edge(_line(b.verts[v[1]], b.verts[v[3]]), v[1], v[3])

    def side_grid(t0, t1):
        t = np.linspace(t0, t1, N_GRID)
        z = np.linspace(0, height, N_GRID)
        r = r_bot + (r_top - r_bot) * (z / height)  # [N_GRID] per row
        return np.stack(
            [
                np.cos(t)[:, None] * r[None, :],
                np.sin(t)[:, None] * r[None, :],
                np.broadcast_to(z[None, :], (N_GRID, N_GRID)),
            ],
            -1,
        )

    b.face(side_grid(0, np.pi), [bot_a, top_a, seam0, seam1])
    b.face(side_grid(np.pi, 2 * np.pi), [bot_b, top_b, seam1, seam0])
    for z, r, ea, eb in ((0.0, r_bot, bot_a, bot_b),
                         (height, r_top, top_a, top_b)):
        b.face(_planar_grid([-r, -r, z], [2 * r, 0, 0], [0, 2 * r, 0]),
               [ea, eb])
    return b.build(uid)


def random_heldout_solid(rng: np.random.Generator, uid: str = "") -> Dict:
    """A solid from the HELD-OUT family (lblock/frustum) -- shapes the
    recovery ladder was never tuned or validated on."""
    if rng.choice(["lblock", "frustum"]) == "lblock":
        sx, sy = rng.uniform(1.0, 2.4, 2)
        cx = rng.uniform(0.3, 0.7) * sx
        cy = rng.uniform(0.3, 0.7) * sy
        return make_lblock(sx, sy, rng.uniform(0.4, 2.0), cx, cy,
                           uid=uid or f"lblock_{rng.integers(1<<30)}")
    return make_frustum(rng.uniform(0.8, 1.5), rng.uniform(0.3, 0.7),
                        rng.uniform(0.4, 2.0),
                        uid=uid or f"frustum_{rng.integers(1<<30)}")


def random_solid(rng: np.random.Generator, uid: str = "") -> Dict:
    """A randomly-scaled solid from the synthetic family."""
    kind = rng.choice(["cuboid", "prism", "cylinder"])
    if kind == "cuboid":
        s = rng.uniform(0.4, 2.0, 3)
        return make_cuboid(*s, uid=uid or f"cuboid_{rng.integers(1<<30)}")
    if kind == "prism":
        n = int(rng.integers(3, 8))
        return make_prism(n, rng.uniform(0.5, 1.5), rng.uniform(0.4, 2.0),
                          uid=uid or f"prism{n}_{rng.integers(1<<30)}")
    return make_cylinder(rng.uniform(0.5, 1.5), rng.uniform(0.4, 2.0),
                         uid=uid or f"cyl_{rng.integers(1<<30)}")


def make_dataset(num: int, seed: int = 0, family: str = "all") -> List[Dict]:
    rng = np.random.default_rng(seed)
    if family == "all":
        return [random_solid(rng, uid=f"synth_{i:06d}") for i in range(num)]
    if family == "heldout":
        return [random_heldout_solid(rng, uid=f"held_{i:06d}")
                for i in range(num)]
    raise ValueError(f"unknown family {family!r}")
