"""Deduplication of solids / surfaces / edges by quantized-geometry hashes.

The port's own copy of ``brepgen_tpu/data/dedup.py`` (numpy and hashlib).
Parity with reference ``data_process/deduplicate_cad.py`` (whole-solid
dedup: sha256 over each face's n-bit-quantized points, sorted and joined)
and ``deduplicate_surfedge.py`` (per-surface / per-edge dedup into flat
arrays for VAE training). ``real2bit`` matches ``convert_utils.py:32-37``.
"""

from __future__ import annotations

from hashlib import sha256
from typing import Dict, Iterable, List

import numpy as np


def real2bit(data: np.ndarray, n_bits: int = 8, min_range=-1.0, max_range=1.0) -> np.ndarray:
    """Quantize [-1,1] floats to integers in [0, 2^n_bits - 1]."""
    range_quantize = 2**n_bits - 1
    q = (data - min_range) * range_quantize / (max_range - min_range)
    return np.clip(q, 0, range_quantize).astype(int)


def solid_hash(surf_wcs: Iterable[np.ndarray], n_bits: int = 6) -> str:
    """Order-invariant hash of a solid's face geometry."""
    hashes = sorted(
        sha256(real2bit(s, n_bits=n_bits).reshape(-1, 3).tobytes()).hexdigest()
        for s in surf_wcs
    )
    return "_".join(hashes)


def dedup_solids(samples: List[Dict], n_bits: int = 6) -> List[int]:
    """Indices of first-occurrence unique solids."""
    seen, keep = set(), []
    for i, data in enumerate(samples):
        h = solid_hash(data["surf_wcs"], n_bits)
        if h not in seen:
            seen.add(h)
            keep.append(i)
    return keep


def dedup_primitives(
    samples: List[Dict], kind: str = "surface", n_bits: int = 6
) -> np.ndarray:
    """Unique surf_ncs grids / edge_ncs curves across samples (flat array)."""
    key = "surf_ncs" if kind == "surface" else "edge_ncs"
    seen = set()
    unique = []
    for data in samples:
        arr = data[key]
        bits = real2bit(arr, n_bits=n_bits)
        for np_bit, np_real in zip(bits, arr):
            h = sha256(np_bit.reshape(-1, 3).tobytes()).hexdigest()
            if h not in seen:
                seen.add(h)
                unique.append(np_real)
    return np.stack(unique)
