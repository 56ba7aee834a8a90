"""Port: the plain Chamfer matrix (``chamfer_matrix_reference``, the version
kernel K4 is held to on the card) on unit-cube surface clouds with
near-duplicate points, against the JAX package on the CPU and against the
same matrix in f64.

Each sample cloud is a box surface inside the unit cube, sampled and scaled
as the eval protocol's ``normalize_pc`` does; its reference twin is the
same points with a jitter of 1e-4, shuffled, so the nearest distances are
about 1e-4 to 1e-3 and the matrix entries of twin pairs about 1e-8 to 1e-7:
where f32 precision matters. Tolerances:
- plain against f64 (the same f32 inputs): ``REL * |f64| + TINY``. Direct
  differences of near points are exact (Sterbenz) and each squared
  distance is a few roundings, so the error is relative to the value.
- the JAX Pallas body in interpret mode (the same direct-difference form,
  ``(dx^2 + dy^2) + dz^2``) against plain: the same bar.
- the JAX XLA path (``eval/metrics.py:_chamfer_block``) computes the
  expansion ``|x|^2 + |y|^2 - 2 x.y``, which cancels: its error is absolute,
  a few f32 roundings of |x|^2 + |y|^2 <= 6, so it is held to ``XLA_ABS``
  against f64, and on twin pairs it is shown to be far less accurate than
  the direct form, which is why K4 keeps direct differences.
"""

import numpy as np
import torch

from brepgen_tpu.eval import metrics as j_metrics
from brepgen_tpu.kernels.chamfer import chamfer_matrix as j_chamfer_pallas
from brepgen_tpu_torch.eval.metrics import normalize_pc
from brepgen_tpu_torch.kernels.chamfer import chamfer_matrix, chamfer_matrix_reference

REL, TINY = 1e-5, 1e-12
XLA_ABS = 2e-6  # 2 directions x a few roundings of 6 at f32 (2^-24 ~ 6e-8)
JITTER = 1e-4


def box_surface(rng, n):
    """n points uniform by area on the surface of a random box inside the
    unit cube, then centred and scaled as the eval protocol does."""
    lo = rng.uniform(0.0, 0.3, 3)
    hi = lo + rng.uniform(0.3, 0.7, 3)
    size = hi - lo
    areas = np.tile([size[1] * size[2], size[0] * size[2], size[0] * size[1]], 2)
    face = rng.choice(6, size=n, p=areas / areas.sum())
    pts = lo + rng.random((n, 3)) * size
    axis = face % 3
    pts[np.arange(n), axis] = np.where(face < 3, lo[axis], hi[axis])
    return normalize_pc(pts)


def unitcube_clouds(S, R, P, seed):
    """S box clouds, and R references: the first min(S, R) the twins of the
    samples (jittered by JITTER, shuffled), the rest other boxes."""
    rng = np.random.default_rng(seed)
    x = np.stack([box_surface(rng, P) for _ in range(S)])
    twins = [x[r][rng.permutation(P)] + rng.normal(scale=JITTER, size=(P, 3))
             for r in range(min(S, R))]
    y = np.stack(twins + [box_surface(rng, P) for _ in range(R - len(twins))])
    return x.astype(np.float32), y.astype(np.float32)


def chamfer_f64(x, y):
    x, y = x.astype(np.float64), y.astype(np.float64)
    d2 = ((x[:, None, :, None, :] - y[None, :, None, :, :]) ** 2).sum(-1)
    return d2.min(3).mean(2) + d2.min(2).mean(2)


def test_plain_on_near_duplicates_against_f64_and_jax():
    S, R, P = 4, 6, 160
    x, y = unitcube_clouds(S, R, P, seed=13)
    exact = chamfer_f64(x, y)
    twins = np.arange(S)
    # the twin entries are the near-duplicate ones: 1e-8 to 1e-7
    assert (exact[twins, twins] < 2e-7).all() and (exact[twins, twins] > 1e-9).all()

    plain = chamfer_matrix_reference(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert (np.abs(plain - exact) <= REL * np.abs(exact) + TINY).all()
    assert np.array_equal(plain, chamfer_matrix(torch.from_numpy(x), torch.from_numpy(y)).numpy())

    pallas = np.asarray(j_chamfer_pallas(x, y, block_s=4, block_r=2, chunk=64, interpret=True))
    assert (np.abs(pallas - plain) <= REL * np.abs(plain) + TINY).all()

    xla = j_metrics.pairwise_chamfer(x, y, block=2, backend="xla")
    assert (np.abs(xla - exact) <= XLA_ABS).all()
    # on the twins the expansion's error dwarfs the direct form's
    err_direct = np.abs(plain - exact)[twins, twins].max()
    err_xla = np.abs(xla - exact)[twins, twins].max()
    assert err_xla > 100 * err_direct, (err_xla, err_direct)


def test_plain_with_padding_on_near_duplicates():
    """n < P, the padding NaN: the first n points of each cloud count."""
    S, R, P, n = 3, 2, 70, 61
    x, y = unitcube_clouds(S, R, P, seed=29)
    x[:, n:] = np.nan
    y[:, n:] = np.nan
    exact = chamfer_f64(x[:, :n], y[:, :n])
    plain = chamfer_matrix_reference(torch.from_numpy(x), torch.from_numpy(y), n).numpy()
    assert (np.abs(plain - exact) <= REL * np.abs(exact) + TINY).all()


def test_smoke_bound_counts_each_distance_once():
    """chip_smoke.py's K4 bound: S*R*n^2 distances of 8 FLOP at the f32
    rate, each distance counted once (31.30 ms at the eval protocol's 256 x
    256 x 2000, 1432.8 ms a protocol repeat of 3000 x 1000 x 2000)."""
    import chip_smoke

    ms, by = chip_smoke.chamfer_bound(256, 256, 2000, 2000)
    assert by == "operations" and abs(ms - 256 * 256 * 2000 ** 2 * 8 / 67e12 * 1e3) < 1e-9
    assert round(ms, 2) == 31.30
    assert round(chip_smoke.chamfer_bound(3000, 1000, 2000, 2000)[0], 1) == 1432.8
