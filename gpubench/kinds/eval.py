"""Scoring cells: repeats of the point-cloud protocol of ``pc_metric.py``
through ``brepgen_tpu_torch.eval.metrics``.

Set-up makes a pool of sample clouds and a pool of reference clouds on the
device from the seed (N(0, 0.3^2) points, each cloud centred and scaled to
the unit cube as the protocol loads them) and hands them to the program as
host arrays, as the protocol's loader does. Set-up also draws, from the
seed, a few orders of the protocol's 3 x 1000 samples and 1000 references
(every cloud of the pools, in a new order) and lays each out as host arrays,
so that the window holds no work of the benchmark's own. A repeat takes the
next order in turn, their Chamfer matrix (``pairwise_chamfer``: kernel K4
on the card, the matrix back on the host), MMD-CD and COV-CD from it, and
JSD of the two sets. Repeats run back to back; the last that starts inside
the window runs to its end.

The check recomputes Chamfer rows drawn from the seed in float32 by direct
differences (``chamfer_gap``, the largest relative gap of an entry), and
MMD, COV and JSD from the program's matrix and the benchmark's clouds
(``metric_gap``).
"""

from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from gpubench import counts, trace
from gpubench.kinds.common import free_cuda, seeds, worst
from gpubench.reference import metrics as ref
from gpubench.reference.precision import exact

WARMUP_ROWS = 64
JSD_REPEATS = 2  # repeats whose JSD the reference recomputes


class Run:
    def __init__(self, config: dict, mix: dict, seed: int, device: torch.device):
        self.mix, self.device = mix, device
        e = dict(config["eval"])
        if device.type == "cpu":  # a rehearsal's size
            e.update(n_samples=24, n_refs=8, points=64)
        self.n_s, self.n_r, self.points = e["n_samples"], e["n_refs"], e["points"]
        self.data_seed, self.order_seed, self.check_seed = seeds(seed, 3)
        self.repeats: List[dict] = []

    def setup(self) -> None:
        from brepgen_tpu_torch.eval import metrics as program

        self.program = program
        gen = torch.Generator(device=self.device).manual_seed(self.data_seed)
        clouds = torch.randn((self.n_s + self.n_r, self.points, 3), generator=gen,
                             device=self.device) * 0.3
        clouds = clouds - clouds.mean(dim=1, keepdim=True)
        clouds = clouds / clouds.abs().amax(dim=(1, 2), keepdim=True)
        self.clouds = clouds
        host = clouds.cpu().numpy()
        self.fake, self.real = host[:self.n_s], host[self.n_s:]
        order = np.random.default_rng(self.order_seed)
        self.orders = []
        for _ in range(int(self.mix["orders"])):
            s_idx, r_idx = order.permutation(self.n_s), order.permutation(self.n_r)
            self.orders.append((s_idx, r_idx, self.fake[s_idx], self.real[r_idx]))
        warm = self.program.pairwise_chamfer(self.fake[:WARMUP_ROWS], self.real, self.device)
        if not np.isfinite(warm).all():
            raise RuntimeError("non-finite Chamfer distances in the warm-up")
        self.program.jsd_between_point_cloud_sets(self.fake[:WARMUP_ROWS], self.real)

    def _repeat(self) -> dict:
        s_idx, r_idx, s, r = self.orders[len(self.repeats) % len(self.orders)]
        with trace.span("eval.chamfer"):
            d = self.program.pairwise_chamfer(s, r, self.device)
        with trace.span("eval.metrics"):
            res = self.program.cov_mmd_from_matrix(d)
            res["JSD"] = self.program.jsd_between_point_cloud_sets(s, r)
        return {"s_idx": s_idx, "r_idx": r_idx, "d": d, "result": res}

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        while not self.repeats or time.perf_counter() - t0 < seconds:
            self.repeats.append(self._repeat())
        elapsed = time.perf_counter() - t0
        failed = sum(not np.isfinite(r["d"]).all() for r in self.repeats)
        ops, _ = counts.chamfer(self.n_s, self.n_r, self.points)
        return {
            "metrics": {"eval_s_per_repeat": elapsed / len(self.repeats)},
            "attempted": len(self.repeats),
            "failed": int(failed),
            "records": {"window_s": elapsed, "repeats": len(self.repeats),
                        "chamfer_ops": ops * len(self.repeats), "dtype": "f32"},
        }

    def traced(self) -> dict:
        _, summary = trace.traced(self._repeat)
        ops, nbytes = counts.chamfer(self.n_s, self.n_r, self.points)
        summary["work"] = {"chamfer_ops": ops, "chamfer_bytes": nbytes, "dtype": "f32"}
        return summary

    def release(self) -> None:
        free_cuda()

    def readings(self, control: bool = False) -> dict:
        """``chamfer_gap``: sampled rows of every repeat's matrix against
        the reference's; ``metric_gap``: MMD, COV and JSD against the
        reference's. With ``control`` the reference one precision below the
        configuration's stands in the program's place: TF32 Chamfer rows,
        MMD and COV reduced in bf16 (JSD's counts are exact in any type)."""
        rng = np.random.default_rng(self.check_seed)
        k = int(self.mix["check_rows"])
        cgap = mgap = 0.0
        with exact("f32"):
            for n, rep in enumerate(self.repeats):
                rows = rng.choice(self.n_s, size=min(k, self.n_s), replace=False)
                s_rows = self.clouds[torch.as_tensor(rep["s_idx"][rows], device=self.device)]
                r_all = self.clouds[self.n_s + torch.as_tensor(rep["r_idx"], device=self.device)]
                want = ref.chamfer_rows(s_rows, r_all, "f32").double().cpu().numpy()
                if control:
                    with exact("tf32"):
                        got = ref.chamfer_rows(s_rows, r_all, "tf32").double().cpu().numpy()
                else:
                    got = rep["d"][rows].astype(np.float64)
                gap = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
                cgap = worst(cgap, float(gap.max()) if np.isfinite(gap).all() else float("inf"))
                res = ref.cov_mmd(rep["d"], "bf16") if control else rep["result"]
                ref_res = ref.cov_mmd(rep["d"])
                mgap = worst(mgap, abs(res["MMD-CD"] - ref_res["MMD-CD"]) / ref_res["MMD-CD"],
                             abs(res["COV-CD"] - ref_res["COV-CD"]))
                if n < JSD_REPEATS and not control:
                    j = ref.jsd(self.fake[rep["s_idx"]], self.real[rep["r_idx"]])
                    mgap = worst(mgap, abs(res["JSD"] - j) / max(j, 1e-30))
        return {"chamfer_gap": cgap, "metric_gap": mgap}
