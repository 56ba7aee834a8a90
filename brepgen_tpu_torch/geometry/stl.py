"""Binary STL writer/reader (replaces the reference's OCC ``write_stl_file``
and trimesh loading -- pure numpy, no geometry-kernel dependency).

The port's own copy of ``brepgen_tpu/geometry/stl.py``, unchanged in behaviour.
"""

from __future__ import annotations

import struct

import numpy as np


def write_stl(path: str, triangles: np.ndarray) -> None:
    """triangles: [T, 3, 3] vertex coordinates."""
    tris = np.asarray(triangles, np.float32)
    T = len(tris)
    e1 = tris[:, 1] - tris[:, 0]
    e2 = tris[:, 2] - tris[:, 0]
    normals = np.cross(e1, e2)
    norm = np.linalg.norm(normals, axis=1, keepdims=True)
    normals = np.where(norm > 1e-12, normals / np.maximum(norm, 1e-12), 0.0).astype(np.float32)

    rec = np.zeros(T, dtype=[("data", "<f4", (12,)), ("pad", "<u2")])
    rec["data"][:, :3] = normals
    rec["data"][:, 3:] = tris.reshape(T, 9)
    with open(path, "wb") as f:
        f.write(b"\x00" * 80)
        f.write(struct.pack("<I", T))
        f.write(rec.tobytes())


def read_stl(path: str) -> np.ndarray:
    """Returns triangles [T, 3, 3]. Supports binary and ASCII STL."""
    with open(path, "rb") as f:
        head = f.read(80)
        rest = f.read()
    if head[:5].lower() == b"solid" and b"facet" in rest[:1000]:
        # probably ASCII (unless a binary file starting with 'solid')
        try:
            return _read_ascii(head + rest)
        except Exception:
            pass
    T = struct.unpack("<I", rest[:4])[0]
    body = np.frombuffer(rest[4 : 4 + T * 50], dtype=np.uint8).reshape(T, 50)
    floats = body[:, :48].copy().view("<f4").reshape(T, 12)
    return floats[:, 3:].reshape(T, 3, 3).astype(np.float64)


def _read_ascii(data: bytes) -> np.ndarray:
    verts = []
    for line in data.decode("ascii", errors="ignore").splitlines():
        parts = line.split()
        if parts[:1] == ["vertex"]:
            verts.append([float(x) for x in parts[1:4]])
    v = np.asarray(verts)
    assert len(v) % 3 == 0 and len(v) > 0
    return v.reshape(-1, 3, 3)
