"""Protocol-scale Chamfer-matrix timing (the eval protocol's cost).

Port of ``scripts/chamfer_protocol_bench.py``. One repeat of the reference
metric protocol is a [3000 x 1000] Chamfer matrix over 2000-point clouds
(``pc_metric.py:45-95,327-333``). This times ``eval/metrics.py:
pairwise_chamfer`` (kernel K4 on the card) on that shape: a warm-up on a
256-row slice (``BREPGEN_CHAMFER_SLICE``), the first full call, then a
repeat on fresh clouds; each call returns the matrix to the host, which
synchronises. It reports seconds a repeat, the ten-repeat projection, and
MMD/COV of the first matrix as a sanity check::

    python -m brepgen_tpu_torch.tools.chamfer_protocol_bench [out.json] [--device cpu]

The report goes to ``out.json`` (default ``artifacts/chamfer_protocol.json``)
and to stdout as one JSON line; ``backend`` names the card (or "cpu"), and
its power limit goes to stderr. The JAX script salts its clouds from
``os.urandom`` against its remote backend's result cache; a CUDA card
caches nothing, so the clouds come from ``SEED``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, Tuple

import numpy as np

from brepgen_tpu_torch import card, card_line, resolve_device

N_FAKE, N_REAL, P = 3000, 1000, 2000
SEED = 0


def clouds(rng: np.random.Generator, n: int, points: int) -> np.ndarray:
    """``n`` clouds of ``points`` N(0, 0.3^2) points, f32, as the JAX script draws."""
    return rng.normal(size=(n, points, 3)).astype(np.float32) * 0.3


def protocol(fake: np.ndarray, real: np.ndarray, fake2: np.ndarray, device,
             rows: int = 256) -> Tuple[Dict, np.ndarray, np.ndarray]:
    """(report fields, first matrix, repeat matrix): the warm-up slice, the
    timed first call on (fake, real) and the timed repeat on (fake2, real)."""
    from brepgen_tpu_torch.eval.metrics import cov_mmd_from_matrix, pairwise_chamfer

    d_small = pairwise_chamfer(fake[:rows], real, device)
    if not np.isfinite(d_small).all():
        raise RuntimeError("non-finite Chamfer distances in the warm-up slice")
    t0 = time.perf_counter()
    d = pairwise_chamfer(fake, real, device)     # returned to the host: synchronised
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    d2 = pairwise_chamfer(fake2, real, device)
    t_repeat = time.perf_counter() - t0
    if not (np.isfinite(d).all() and np.isfinite(d2).all()):
        raise RuntimeError("non-finite Chamfer distances")
    sanity = cov_mmd_from_matrix(d)
    return {
        "first_call_s": t_first,
        "steady_repeat_s": t_repeat,
        "ten_repeat_projection_min": 10 * t_repeat / 60.0,
        "mmd_sanity": sanity["MMD-CD"],
        "cov_sanity": sanity["COV-CD"],
    }, d, d2


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("out", nargs="?", default="artifacts/chamfer_protocol.json")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    info = card(dev)
    print(card_line(info), file=sys.stderr, flush=True)
    rng = np.random.default_rng(SEED)
    fake, real = clouds(rng, N_FAKE, P), clouds(rng, N_REAL, P)
    fake2 = clouds(rng, N_FAKE, P)
    rows = int(os.environ.get("BREPGEN_CHAMFER_SLICE", 256))
    fields, _, _ = protocol(fake, real, fake2, dev, rows)
    report = {"backend": info["device"],
              "shape": f"{N_FAKE}x{N_REAL} pairs, {P} pts", **fields}
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
