"""Vectorized whole-batch assembly (host input pipeline, fast path).

The port's own numpy copy of ``brepgen_tpu/data/batch_assembly.py``, with the same
draws per (sample, seed).

The per-sample functions in ``assembly.py`` mirror the reference
``Dataset.__getitem__``s (``dataset.py:120-589``) one sample at a time;
at production batch sizes their cost is pure Python/numpy *dispatch*
overhead (~350 us/sample at [30, 6] shapes — ``scripts/io_bench.py``
measured 5.7 batches/s for surfpos@512 vs 10.5 device steps/s, a
host-bound pipeline on a 1-core host where a worker pool cannot help).

This module assembles the SAME distributions with a handful of numpy ops
per *batch*:

  * a cheap per-sample **draw phase** replays the exact RNG call sequence
    of the per-sample path (``np.random.default_rng(seed)`` per sample —
    the Batcher's seeding scheme), so every random decision (aug coin,
    rotation angles, shuffles) is bit-identical;
  * a vectorized **apply phase** executes the geometry on padded
    [B, ...] buffers: batched rotation via one einsum per axis (identity
    matrices for un-augmented samples), bbox reduction, and a single
    fancy-index gather that fuses shuffle + pad_repeat/pad_zero + the
    final slot shuffle into one composed index map.

Outputs match ``assembly.py`` to f32 round-off (golden-tested in
``tests/test_data.py``); masks match exactly.  The gather composition for
``pad_repeat`` (reference ``utils.py:100-112``) maps output slot k of an
n-item set to source index ``k // (r+1)`` for ``k < sep*(r+1)`` else
``sep + (k - sep*(r+1)) // r`` with ``r = floor(L/n)``, ``sep = L - r*n``.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Sequence, Tuple

import numpy as np

from brepgen_tpu_torch.data.augment import _rotation_matrix

_ANGLES = (90, 180, 270)
# LUT[axis_index][angle//90 - 1] -> exact same f64 matrices the per-sample
# path builds through augment._rotation_matrix.
_ROT_LUT = np.stack(
    [
        np.stack([_rotation_matrix(a, ax) for a in _ANGLES])
        for ax in ("x", "y", "z")
    ]
)  # [3, 3, 3, 3]


@functools.lru_cache(maxsize=256)
def _pad_repeat_idx(n: int, length: int) -> np.ndarray:
    """Index map of ``pad.pad_repeat`` for an n-item input (cached)."""
    k = np.arange(length)
    r, sep = length // n, length % n
    lead = sep * (r + 1)
    return np.where(k < lead, k // (r + 1), sep + (k - lead) // max(r, 1))


def _bbox_corners_b(bboxes: np.ndarray) -> np.ndarray:
    """[B, N, 6] -> [B, N, 8, 3], corner order of ``augment.bbox_corners``."""
    mn, mx = bboxes[..., :3], bboxes[..., 3:]
    corners = []
    for sx in (0, 1):
        for sy in (0, 1):
            for sz in (0, 1):
                sel = (sx, sy, sz)
                corners.append(
                    np.stack(
                        [np.where(s, mx[..., d], mn[..., d]) for d, s in enumerate(sel)],
                        -1,
                    )
                )
    return np.stack(corners, -2)


def _rotate_batched(
    arrays: List[np.ndarray],
    normalized: Sequence[bool],
    coins: np.ndarray,
    angle_idx: np.ndarray,
) -> List[np.ndarray]:
    """Batched ``augment.random_rotate_grids``: batched-BLAS matmuls, not
    einsum (numpy's ellipsis-broadcast einsum path is ~20x slower here).
    Normalized arrays apply the three axis rotations sequentially (same op
    order as the per-sample path, so the per-axis unit-cube
    renormalization telescopes identically); non-normalized arrays (the
    big ncs grids) get ONE composed rotation ``R3@R2@R1`` — equal to
    within f64 round-off, invisible at the f32 output precision.
    Un-augmented samples get identity matrices and divisor 1.  Padded rows
    are zero and cannot affect the per-sample abs-max."""
    if not coins.any():
        return list(arrays)
    B = len(coins)
    eye = np.broadcast_to(np.eye(3), (B, 3, 3))
    Rs = [
        np.where(coins[:, None, None], _ROT_LUT[ax][angle_idx[:, ax]], eye)
        for ax in range(3)
    ]
    Rc_T = np.matmul(np.matmul(Rs[2], Rs[1]), Rs[0]).transpose(0, 2, 1)
    out = []
    for a, norm in zip(arrays, normalized):
        a = np.asarray(a)
        shp = a.shape
        flat = a.reshape(B, -1, 3)  # keeps input dtype (f32 grids use sgemm)
        if norm:
            for R in Rs:
                flat = np.matmul(flat, R.transpose(0, 2, 1).astype(flat.dtype))
                m = np.max(np.abs(flat), axis=(1, 2))
                flat = flat / np.where(coins, m, 1.0)[:, None, None].astype(flat.dtype)
        else:
            flat = np.matmul(flat, Rc_T.astype(flat.dtype))
        out.append(flat.reshape(shp))
    return out


def _fill(buf: np.ndarray, arrays: Sequence[np.ndarray]) -> np.ndarray:
    for b, a in enumerate(arrays):
        buf[b, : len(a)] = a
    return buf


def _draw_coin_angles(rng, aug: bool):
    if aug and rng.random() > 0.5:
        return True, np.array([_ANGLES.index(rng.choice([90, 180, 270])) for _ in range(3)])
    return False, np.zeros(3, np.int64)


# ---------------------------------------------------------------------------
# surfpos


def assemble_surfpos_batched(
    samples: Sequence[Dict],
    seeds: Sequence[int],
    max_face: int,
    bbox_scaled: float = 3.0,
    aug: bool = False,
) -> Tuple[np.ndarray]:
    """Batched ``assembly.assemble_surfpos`` (reference ``dataset.py``
    SurfPos ``__getitem__``): rotation aug, x``bbox_scaled``, shuffle +
    pad_repeat + shuffle — identical draws per (sample, seed)."""
    B = len(samples)
    pos_raw = [np.asarray(s["surf_bbox_wcs"]) for s in samples]
    nfs = np.array([len(p) for p in pos_raw])
    maxn = int(nfs.max())

    coins = np.zeros(B, bool)
    angle_idx = np.zeros((B, 3), np.int64)
    gather = np.empty((B, max_face), np.int64)
    for b, seed in enumerate(seeds):
        rng = np.random.default_rng(seed)
        coins[b], angle_idx[b] = _draw_coin_angles(rng, aug)
        perm1 = rng.permutation(nfs[b])
        perm2 = rng.permutation(max_face)
        gather[b] = perm1[_pad_repeat_idx(int(nfs[b]), max_face)][perm2]

    pos = _fill(np.zeros((B, maxn, 6)), pos_raw)
    corners = _bbox_corners_b(pos)
    (corners,) = _rotate_batched([corners], [True], coins, angle_idx)
    pos = (np.concatenate([corners.min(-2), corners.max(-2)], -1) * bbox_scaled).astype(np.float32)
    return (pos[np.arange(B)[:, None], gather],)


# ---------------------------------------------------------------------------
# surfz


def assemble_surfz_batched(
    samples: Sequence[Dict],
    seeds: Sequence[int],
    max_face: int,
    bbox_scaled: float = 3.0,
    aug: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    B = len(samples)
    pos_raw = [np.asarray(s["surf_bbox_wcs"]) for s in samples]
    ncs_raw = [np.asarray(s["surf_ncs"]) for s in samples]
    nfs = np.array([len(p) for p in pos_raw])
    maxn = int(nfs.max())

    coins = np.zeros(B, bool)
    angle_idx = np.zeros((B, 3), np.int64)
    # sentinel index maxn points at a row that stays all-zero through the
    # whole pipeline (rotation/scale of 0 is 0) -> pad_zero for free
    gather = np.full((B, max_face), maxn, np.int64)
    valid = np.zeros((B, max_face), bool)
    for b, seed in enumerate(seeds):
        rng = np.random.default_rng(seed)
        coins[b], angle_idx[b] = _draw_coin_angles(rng, aug)
        perm = rng.permutation(nfs[b])
        gather[b, : nfs[b]] = perm
        valid[b, : nfs[b]] = True

    pos = _fill(np.zeros((B, maxn + 1, 6)), pos_raw)
    ncs = _fill(np.zeros((B, maxn + 1) + ncs_raw[0].shape[1:], np.float32), ncs_raw)
    corners = _bbox_corners_b(pos)
    corners, ncs = _rotate_batched([corners, ncs], [True, False], coins, angle_idx)
    pos = (np.concatenate([corners.min(-2), corners.max(-2)], -1) * bbox_scaled).astype(np.float32)

    bidx = np.arange(B)[:, None]
    return (pos[bidx, gather], ncs[bidx, gather], ~valid)


# ---------------------------------------------------------------------------
# edgepos


def assemble_edgepos_batched(
    samples: Sequence[Dict],
    seeds: Sequence[int],
    max_face: int,
    max_edge: int,
    bbox_scaled: float = 3.0,
    aug: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    B = len(samples)
    spos_raw = [np.asarray(s["surf_bbox_wcs"]) for s in samples]
    epos_raw = [np.asarray(s["edge_bbox_wcs"]) for s in samples]
    ncs_raw = [np.asarray(s["surf_ncs"]) for s in samples]
    adjs = [s["faceEdge_adj"] for s in samples]
    nfs = np.array([len(p) for p in spos_raw])
    maxn = int(nfs.max())
    maxe = int(max(len(p) for p in epos_raw))

    coins = np.zeros(B, bool)
    angle_idx = np.zeros((B, 3), np.int64)
    # sentinel indices (maxn / maxe) select all-zero rows -> pad_zero free
    sgather = np.full((B, max_face), maxn, np.int64)
    fvalid = np.zeros((B, max_face), bool)
    egather = np.full((B, max_face, max_edge), maxe, np.int64)
    for b, seed in enumerate(seeds):
        rng = np.random.default_rng(seed)
        coins[b], angle_idx[b] = _draw_coin_angles(rng, aug)
        n = int(nfs[b])
        gmat = np.empty((n, max_edge), np.int64)
        for f in range(n):
            adj = np.asarray(adjs[b][f])
            pA = rng.permutation(len(adj))
            pB = rng.permutation(max_edge)
            gmat[f] = adj[pA][_pad_repeat_idx(len(adj), max_edge)][pB]
        perm = rng.permutation(n)
        sgather[b, :n] = perm
        egather[b, :n] = gmat[perm]
        fvalid[b, :n] = True

    spos = _fill(np.zeros((B, maxn + 1, 6)), spos_raw)
    epos = _fill(np.zeros((B, maxe + 1, 6)), epos_raw)
    ncs = _fill(np.zeros((B, maxn + 1) + ncs_raw[0].shape[1:], np.float32), ncs_raw)
    s_corners = _bbox_corners_b(spos)
    e_corners = _bbox_corners_b(epos)
    s_corners, e_corners, ncs = _rotate_batched(
        [s_corners, e_corners, ncs], [True, True, False], coins, angle_idx
    )
    spos = (np.concatenate([s_corners.min(-2), s_corners.max(-2)], -1) * bbox_scaled).astype(np.float32)
    epos = (np.concatenate([e_corners.min(-2), e_corners.max(-2)], -1) * bbox_scaled).astype(np.float32)

    bidx = np.arange(B)[:, None]
    out_epos = epos[bidx[:, :, None], egather]
    out_spos = spos[bidx, sgather]
    out_ncs = ncs[bidx, sgather]
    return (out_epos, out_ncs, out_spos, ~fvalid)


# ---------------------------------------------------------------------------
# edgez


def assemble_edgez_batched(
    samples: Sequence[Dict],
    seeds: Sequence[int],
    max_face: int,
    max_edge: int,
    bbox_scaled: float = 3.0,
    aug: bool = False,
):
    """Batched ``assembly.assemble_edgez``; returns
    (edge_ncs, edge_pos, edge_mask, surf_ncs, surf_pos, vert_pos).

    The per-edge endpoint lexsort (reference ``dataset.py`` EdgeZ
    ``__getitem__``) reduces to a single vectorized conditional swap: for
    two points, ``np.lexsort`` keyed (z, y, x) is "swap iff p0 > p1
    lexicographically by (x, y, z)" (stable on ties)."""
    B = len(samples)
    spos_raw = [np.asarray(s["surf_bbox_wcs"]) for s in samples]
    epos_raw = [np.asarray(s["edge_bbox_wcs"]) for s in samples]
    sncs_raw = [np.asarray(s["surf_ncs"]) for s in samples]
    encs_raw = [np.asarray(s["edge_ncs"]) for s in samples]
    corner_raw = [np.asarray(s["corner_wcs"]) for s in samples]
    adjs = [s["faceEdge_adj"] for s in samples]
    nfs = np.array([len(p) for p in spos_raw])
    maxn = int(nfs.max())
    maxe = int(max(len(p) for p in epos_raw))

    coins = np.zeros(B, bool)
    angle_idx = np.zeros((B, 3), np.int64)
    # sentinel indices (maxn / maxe) select all-zero rows -> pad_zero free
    sgather = np.full((B, max_face), maxn, np.int64)
    fvalid = np.zeros((B, max_face), bool)
    egather = np.full((B, max_face, max_edge), maxe, np.int64)
    emask = np.ones((B, max_face, max_edge), bool)
    for b, seed in enumerate(seeds):
        rng = np.random.default_rng(seed)
        coins[b], angle_idx[b] = _draw_coin_angles(rng, aug)
        n = int(nfs[b])
        gmat = np.full((n, max_edge), maxe, np.int64)
        mmat = np.ones((n, max_edge), bool)
        for f in range(n):
            adj = np.asarray(adjs[b][f])
            pf = rng.permutation(len(adj))
            gmat[f, : len(adj)] = adj[pf]
            mmat[f, : len(adj)] = False
        perm = rng.permutation(n)
        sgather[b, :n] = perm
        egather[b, :n] = gmat[perm]
        emask[b, :n] = mmat[perm]
        fvalid[b, :n] = True

    spos = _fill(np.zeros((B, maxn + 1, 6)), spos_raw)
    epos = _fill(np.zeros((B, maxe + 1, 6)), epos_raw)
    sncs = _fill(np.zeros((B, maxn + 1) + sncs_raw[0].shape[1:], np.float32), sncs_raw)
    encs = _fill(np.zeros((B, maxe + 1) + encs_raw[0].shape[1:], np.float32), encs_raw)
    vert = _fill(np.zeros((B, maxe + 1, 2, 3)), corner_raw)

    s_corners = _bbox_corners_b(spos)
    e_corners = _bbox_corners_b(epos)
    s_corners, e_corners, vert, sncs, encs = _rotate_batched(
        [s_corners, e_corners, vert, sncs, encs],
        [True, True, True, False, False],
        coins,
        angle_idx,
    )
    spos = (np.concatenate([s_corners.min(-2), s_corners.max(-2)], -1) * bbox_scaled).astype(np.float32)
    epos = (np.concatenate([e_corners.min(-2), e_corners.max(-2)], -1) * bbox_scaled).astype(np.float32)
    vert = vert * bbox_scaled

    # lexsort the two endpoints of every edge (see docstring); comparisons
    # in f64 (per-sample parity), then cast for the gather
    p0, p1 = vert[:, :, 0], vert[:, :, 1]
    swap = (p0[..., 0] > p1[..., 0]) | (
        (p0[..., 0] == p1[..., 0])
        & (
            (p0[..., 1] > p1[..., 1])
            | ((p0[..., 1] == p1[..., 1]) & (p0[..., 2] > p1[..., 2]))
        )
    )
    sw = swap[..., None]
    vert = np.concatenate([np.where(sw, p1, p0), np.where(sw, p0, p1)], -1)  # [B, maxe+1, 6]
    vert = vert.astype(np.float32)

    bidx3 = np.arange(B)[:, None, None]
    bidx = np.arange(B)[:, None]
    out_encs = encs[bidx3, egather]
    out_epos = epos[bidx3, egather]
    out_vert = vert[bidx3, egather]
    out_spos = spos[bidx, sgather]
    out_sncs = sncs[bidx, sgather]
    return (out_encs, out_epos, emask, out_sncs, out_spos, out_vert)
