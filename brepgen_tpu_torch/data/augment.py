"""Geometry helpers and rotation augmentation (reference ``utils.py:210-400``).

The port's own numpy copy of ``brepgen_tpu/data/augment.py``, with the same
draws per (sample, seed).

All pure numpy; used host-side in dataset assembly and postprocessing.
"""

from __future__ import annotations

import numpy as np

_AXES = {"x": 0, "y": 1, "z": 2}


def _rotation_matrix(angle_degrees: float, axis: str) -> np.ndarray:
    a = np.radians(angle_degrees)
    c, s = np.cos(a), np.sin(a)
    if axis == "x":
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
    if axis == "y":
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    if axis == "z":
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    raise ValueError(f"invalid axis {axis}")


def rotate_point_cloud(points: np.ndarray, angle_degrees: float, axis: str) -> np.ndarray:
    """Rotate about the cloud's center and re-normalize to the unit cube
    (reference ``utils.py:210-258`` -- note the re-normalization)."""
    R = _rotation_matrix(angle_degrees, axis)
    center = points.mean(0)
    rotated = (points - center) @ R.T + center
    return rotated / np.max(np.abs(rotated))


def rotate_axis(pnts: np.ndarray, angle_degrees: float, axis: str, normalized: bool = False) -> np.ndarray:
    """Rotate about the origin; optional unit-cube re-normalization
    (reference ``utils.py:320-375``)."""
    R = _rotation_matrix(angle_degrees, axis)
    rotated = pnts @ R.T
    if normalized:
        rotated = rotated / np.max(np.abs(rotated))
    return rotated


def get_bbox(pnts: np.ndarray) -> np.ndarray:
    """[N, ..., 3] -> [N, 2, 3] per-item axis-aligned min/max corners."""
    out = []
    for cloud in pnts:
        flat = cloud.reshape(-1, 3)
        out.append([flat.min(0), flat.max(0)])
    return np.array(out)


def bbox_corners(bboxes: np.ndarray) -> np.ndarray:
    """[N, 6] (min,max corners) -> [N, 8, 3] all eight corners."""
    mn, mx = bboxes[:, :3], bboxes[:, 3:]
    corners = []
    for sx in (0, 1):
        for sy in (0, 1):
            for sz in (0, 1):
                corners.append(
                    np.stack(
                        [
                            np.where(sx, mx[:, 0], mn[:, 0]),
                            np.where(sy, mx[:, 1], mn[:, 1]),
                            np.where(sz, mx[:, 2], mn[:, 2]),
                        ],
                        -1,
                    )
                )
    return np.stack(corners, 1)


def compute_bbox_center_and_size(min_corner: np.ndarray, max_corner: np.ndarray):
    center = (min_corner + max_corner) / 2.0
    size = float(np.max(max_corner - min_corner))
    return center, size


def get_bbox_minmax(point_cloud: np.ndarray):
    return point_cloud.min(0), point_cloud.max(0)


def get_bbox_norm(point_cloud: np.ndarray) -> float:
    return float(np.linalg.norm(point_cloud.max(0) - point_cloud.min(0)))


def random_rotate_grids(rng: np.random.Generator, *arrays, normalized_mask=None):
    """Apply the reference's triple-axis 90-degree-multiple rotation to a
    group of arrays simultaneously (same angles). ``normalized_mask[i]``
    selects whether array i is re-normalized to the unit cube after each
    rotation (True for wcs-space data, False for ncs grids)."""
    if normalized_mask is None:
        normalized_mask = [False] * len(arrays)
    out = list(arrays)
    for axis in ("x", "y", "z"):
        angle = rng.choice([90, 180, 270])
        for i, a in enumerate(out):
            out[i] = rotate_axis(a, angle, axis, normalized=normalized_mask[i])
    return out
