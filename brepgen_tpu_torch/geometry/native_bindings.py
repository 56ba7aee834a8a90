"""ctypes bindings for the port's native host geometry library.

The port's own copy of ``brepgen_tpu/geometry/native_bindings.py``, with one
difference: the library is required. ``geometry/native/brepnative.cpp`` is
compiled at first use with ``g++ -O3 -fPIC -shared -std=c++17
-ffp-contract=off`` (no ``-march=native`` and no fused multiply-adds, so the
same inputs give the same bits on every machine) into
``build/torch_kernels/brepnative-<hash>/libbrepnative.so`` beside the CUDA
kernels (``BREPGEN_TORCH_BUILD_DIR`` overrides the root; the hash covers the
source and the flags, so an edited source is rebuilt). ``CXX`` names another
compiler. A failed build raises with the compiler's message.

The JAX package falls back to numpy when its library is missing; the port
does not, because the two are not the same function: the native
nearest-grid search sums ``dx*dx + dy*dy + dz*dz`` and keeps the first of
equal distances, where numpy takes the argmin of the expanded
``|p|^2 + |g|^2 - 2 p.g``, which rounds otherwise: boundary points equidistant
from two samples go to different cells, and a few boundary cells are trimmed
differently (1250 against 1238 triangles on the caps of
``make_prism(6)``). The numpy versions stay here, as ``*_np``, as the plain
reference the tests hold the library to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List

import numpy as np

from brepgen_tpu_torch.kernels._build import build_root

SOURCE = Path(__file__).resolve().parent / "native" / "brepnative.cpp"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-ffp-contract=off")

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()

_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


def build() -> Path:
    """Compile the library unless a build of this source and these flags
    exists; returns its path."""
    name = os.environ.get("CXX") or "g++"
    cxx = shutil.which(name)
    if not cxx:
        raise RuntimeError(f"C++ compiler {name!r} not found (set CXX): the port's native "
                           f"host library is built from {SOURCE} at first use")
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    out_dir = build_root() / f"brepnative-{digest}"
    lib = out_dir / "libbrepnative.so"
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.NamedTemporaryFile(dir=out_dir, suffix=".so", delete=False) as tmp:
        tmp_path = tmp.name
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp_path, str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed to build {SOURCE}:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp_path, lib)
    finally:
        if os.path.exists(tmp_path):
            os.unlink(tmp_path)
    return lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of the five entries."""
    lib.cells_inside_polygons.argtypes = [
        _f64p, _i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _u8p]
    lib.nearest_grid_index.argtypes = [
        _f64p, ctypes.c_int64, _f64p, ctypes.c_int64, ctypes.c_int64, _f64p]
    lib.tessellate_cells.argtypes = [_f64p, ctypes.c_int64, ctypes.c_int64, _u8p, _f64p]
    lib.tessellate_cells.restype = ctypes.c_int64
    lib.sample_triangles.argtypes = [_f64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64, _f64p]
    lib.chamfer_one_directional.argtypes = [_f64p, ctypes.c_int64, _f64p, ctypes.c_int64]
    lib.chamfer_one_directional.restype = ctypes.c_double
    return lib


def load() -> ctypes.CDLL:
    """Build if needed, then load the library once per process."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(build())))
    return _lib


def cells_inside_polygons(polys: List[np.ndarray], nu: int, nv: int) -> np.ndarray:
    """Even-odd containment of every cell center -> [nu-1, nv-1] bool."""
    lib = load()
    if not polys:
        return np.zeros((nu - 1, nv - 1), bool)
    flat = np.ascontiguousarray(np.concatenate(polys), np.float64)
    sizes = np.asarray([len(p) for p in polys], np.int64)
    out = np.zeros((nu - 1) * (nv - 1), np.uint8)
    lib.cells_inside_polygons(flat, sizes, len(polys), nu, nv, out)
    return out.reshape(nu - 1, nv - 1).astype(bool)


def nearest_grid_index(points: np.ndarray, grid: np.ndarray) -> np.ndarray:
    """(i, j) of the grid sample nearest each point -> [N, 2] float; the
    first of exactly equidistant samples in row-major order."""
    lib = load()
    nu, nv, _ = grid.shape
    pts = np.ascontiguousarray(points, np.float64)
    g = np.ascontiguousarray(grid, np.float64)
    out = np.zeros((len(pts), 2), np.float64)
    lib.nearest_grid_index(pts, len(pts), g, nu, nv, out)
    return out


def tessellate_cells(grid: np.ndarray, inside: np.ndarray) -> np.ndarray:
    """Two triangles per inside cell -> [T, 3, 3] float64."""
    lib = load()
    nu, nv, _ = grid.shape
    g = np.ascontiguousarray(grid, np.float64)
    ins = np.ascontiguousarray(inside.astype(np.uint8))
    out = np.zeros((2 * (nu - 1) * (nv - 1), 3, 3), np.float64)
    n = lib.tessellate_cells(g, nu, nv, ins, out.reshape(-1))
    return out[:n]


def sample_triangles(tris: np.ndarray, n_points: int, seed: int = 0) -> np.ndarray:
    """Area-weighted uniform samples on a triangle soup (mt19937_64 draws)."""
    lib = load()
    t = np.ascontiguousarray(tris, np.float64)
    out = np.zeros((n_points, 3), np.float64)
    lib.sample_triangles(t.reshape(-1), len(t), n_points, seed, out)
    return out


def chamfer_one_directional(a: np.ndarray, b: np.ndarray) -> float:
    """Sum over a of the squared distance to the nearest point of b."""
    lib = load()
    aa = np.ascontiguousarray(a, np.float64)
    bb = np.ascontiguousarray(b, np.float64)
    return float(lib.chamfer_one_directional(aa, len(aa), bb, len(bb)))


# -- the plain numpy versions (the JAX package's fallbacks) ------------------

def cells_inside_polygons_np(polys: List[np.ndarray], nu: int, nv: int) -> np.ndarray:
    ci, cj = np.meshgrid(np.arange(nu - 1) + 0.5, np.arange(nv - 1) + 0.5, indexing="ij")
    inside = np.zeros(ci.shape, bool)
    for poly in polys:
        x, y = poly[:, 0], poly[:, 1]
        x2, y2 = np.roll(x, -1), np.roll(y, -1)
        for k in range(len(poly)):
            cond = ((y[k] > cj) != (y2[k] > cj)) & (
                ci < (x2[k] - x[k]) * (cj - y[k]) / (y2[k] - y[k] + 1e-30) + x[k]
            )
            inside ^= cond
    return inside


def nearest_grid_index_np(points: np.ndarray, grid: np.ndarray) -> np.ndarray:
    nu, nv, _ = grid.shape
    flat = grid.reshape(-1, 3)
    d2 = (
        np.sum(points**2, -1)[:, None]
        + np.sum(flat**2, -1)[None, :]
        - 2.0 * points @ flat.T
    )
    idx = np.argmin(d2, axis=1)
    return np.stack([idx // nv, idx % nv], -1).astype(float)


def tessellate_cells_np(grid: np.ndarray, inside: np.ndarray) -> np.ndarray:
    tris = []
    for i, j in zip(*np.where(inside)):
        a, b, c, d = grid[i, j], grid[i + 1, j], grid[i + 1, j + 1], grid[i, j + 1]
        tris.append([a, b, c])
        tris.append([a, c, d])
    return np.asarray(tris).reshape(-1, 3, 3)


def sample_triangles_np(tris: np.ndarray, n_points: int, seed: int = 0) -> np.ndarray:
    from brepgen_tpu_torch.geometry.sampling import sample_surface

    return sample_surface(tris, n_points, np.random.default_rng(seed))


def chamfer_one_directional_np(a: np.ndarray, b: np.ndarray) -> float:
    d2 = ((a[:, None] - b[None]) ** 2).sum(-1)
    return float(d2.min(1).sum())
