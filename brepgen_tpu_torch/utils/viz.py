"""Visualization helpers (port of ``brepgen_tpu/utils/viz.py``: the
reference's ``plot_3d_bbox``, ``utils.py:121-145``, plus the debug plots of a
cascade sample and a solid). Matplotlib is imported only when a function
runs: the card machine need not have it, and nothing on the sampling or
training path imports this module. Without matplotlib each function raises
an ``ImportError`` that names it."""

from __future__ import annotations

import numpy as np


def _pyplot():
    """matplotlib's pyplot on the Agg backend (files only, no display)."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("brepgen_tpu_torch.utils.viz needs matplotlib, which is not "
                          "installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _poly3d():
    try:
        from mpl_toolkits.mplot3d.art3d import Poly3DCollection
    except ImportError as e:
        raise ImportError("brepgen_tpu_torch.utils.viz needs matplotlib (mpl_toolkits."
                          "mplot3d), which is not installed") from e
    return Poly3DCollection


def _numpy(x) -> np.ndarray:
    """A tensor (on any device) or an array as a numpy array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def plot_3d_bbox(ax, min_corner, max_corner, color="r"):
    """Draw an axis-aligned box wireframe on a 3D axes."""
    Poly3DCollection = _poly3d()
    mn, mx = _numpy(min_corner), _numpy(max_corner)
    v = np.array([
        [mn[0], mn[1], mn[2]], [mx[0], mn[1], mn[2]],
        [mx[0], mx[1], mn[2]], [mn[0], mx[1], mn[2]],
        [mn[0], mn[1], mx[2]], [mx[0], mn[1], mx[2]],
        [mx[0], mx[1], mx[2]], [mn[0], mx[1], mx[2]],
    ])
    faces = [
        [v[0], v[1], v[2], v[3]], [v[4], v[5], v[6], v[7]],
        [v[0], v[1], v[5], v[4]], [v[2], v[3], v[7], v[6]],
        [v[1], v[2], v[6], v[5]], [v[4], v[7], v[3], v[0]],
    ]
    ax.add_collection3d(
        Poly3DCollection(faces, facecolors="blue", linewidths=1, edgecolors=color, alpha=0)
    )


def plot_sample(sample: dict, batch_idx: int, path: str) -> None:
    """Render one cascade output's face boxes to a PNG; ``sample`` holds
    tensors (the cascade's output) or arrays (``batches.npz``)."""
    plt = _pyplot()
    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(projection="3d")
    surf_mask = _numpy(sample["surf_mask"][batch_idx])
    surf_pos = _numpy(sample["surf_pos"][batch_idx])
    for bbox, masked in zip(surf_pos, surf_mask):
        if not masked:
            plot_3d_bbox(ax, bbox[:3], bbox[3:])
    ax.set_xlim(-1, 1), ax.set_ylim(-1, 1), ax.set_zlim(-1, 1)
    fig.savefig(path, dpi=100)
    plt.close(fig)


def plot_solid(solid, path: str) -> None:
    """Render a ``SolidMesh``'s triangles to a PNG."""
    plt = _pyplot()
    Poly3DCollection = _poly3d()
    tris = solid.triangles()
    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(projection="3d")
    ax.add_collection3d(
        Poly3DCollection(list(tris), facecolors="lightsteelblue",
                         edgecolors="gray", linewidths=0.1)
    )
    lo, hi = tris.min(), tris.max()
    ax.set_xlim(lo, hi), ax.set_ylim(lo, hi), ax.set_zlim(lo, hi)
    fig.savefig(path, dpi=100)
    plt.close(fig)
