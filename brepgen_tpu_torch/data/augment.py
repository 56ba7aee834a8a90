"""Bounding-box helpers of ``brepgen_tpu/data/augment.py`` that the
postprocess and trimming paths use; the port's own copy."""

from __future__ import annotations

import numpy as np


def compute_bbox_center_and_size(min_corner: np.ndarray, max_corner: np.ndarray):
    center = (min_corner + max_corner) / 2.0
    size = float(np.max(max_corner - min_corner))
    return center, size


def get_bbox_minmax(point_cloud: np.ndarray):
    return point_cloud.min(0), point_cloud.max(0)


def get_bbox_norm(point_cloud: np.ndarray) -> float:
    return float(np.linalg.norm(point_cloud.max(0) - point_cloud.min(0)))
