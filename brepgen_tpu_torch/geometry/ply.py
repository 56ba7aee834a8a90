"""Minimal binary PLY point-cloud writer/reader (replaces plyfile usage in
the reference's ``sample_points.py:11-17`` / ``pc_metric.py``).

The port's own copy of ``brepgen_tpu/geometry/ply.py``, unchanged in behaviour.
"""

from __future__ import annotations

import numpy as np

_HEADER = """ply
format binary_little_endian 1.0
element vertex {n}
property float x
property float y
property float z
end_header
"""


def write_ply(path: str, points: np.ndarray) -> None:
    pts = np.ascontiguousarray(np.asarray(points, dtype="<f4"))
    with open(path, "wb") as f:
        f.write(_HEADER.format(n=len(pts)).encode("ascii"))
        f.write(pts.tobytes())


def read_ply(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    head_end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:head_end].decode("ascii")
    n = None
    binary = "format binary_little_endian" in header
    for line in header.splitlines():
        if line.startswith("element vertex"):
            n = int(line.split()[-1])
    assert n is not None, "no vertex element"
    if binary:
        return np.frombuffer(data[head_end : head_end + 12 * n], dtype="<f4").reshape(n, 3).astype(np.float64)
    rows = data[head_end:].decode("ascii").split()
    return np.asarray(rows[: 3 * n], float).reshape(n, 3)
