"""Area-weighted point sampling on triangle meshes (replaces trimesh's
``sample_surface`` used at reference ``sample_points.py:65``).

The port's own copy of ``brepgen_tpu/geometry/sampling.py``, unchanged in behaviour.
"""

from __future__ import annotations

import numpy as np


def sample_surface(
    triangles: np.ndarray, n_points: int, rng: np.random.Generator | None = None
) -> np.ndarray:
    """triangles [T, 3, 3] -> points [n_points, 3], area-uniform."""
    rng = rng or np.random.default_rng()
    a, b, c = triangles[:, 0], triangles[:, 1], triangles[:, 2]
    areas = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)
    total = areas.sum()
    if total <= 0:
        raise ValueError("degenerate mesh: zero total area")
    probs = areas / total
    tri_idx = rng.choice(len(triangles), size=n_points, p=probs)
    u = rng.random(n_points)
    v = rng.random(n_points)
    flip = u + v > 1.0
    u = np.where(flip, 1.0 - u, u)
    v = np.where(flip, 1.0 - v, v)
    return (
        a[tri_idx]
        + u[:, None] * (b[tri_idx] - a[tri_idx])
        + v[:, None] * (c[tri_idx] - a[tri_idx])
    )
