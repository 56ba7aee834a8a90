"""Sampling cells: batches of B-reps from ``brepgen_tpu_torch``'s cascade.

The cascade is built as the sample CLI builds it (``Cascade`` over the four
denoisers and both VAEs in the configuration's type, every stage captured as
a CUDA graph on the card), on weights made from the seed. Set-up warms every
stage's graph up with a 4-step DDIM batch that shares the timed cascade's
graphs (same shapes, so the window captures nothing). The window runs
batches back to back; the last batch that starts inside it runs to its end,
and the rate is all B-reps of all batches over the time from the first
batch's start to the last one's end. The mix fixes the sampler: the
published PNDM + DDPM protocol (``fast_steps`` 0) or DDIM.

What each batch produced is kept: every noise draw (the benchmark's own
noise source), every denoiser output as the scheduler received it, and what
each stage returned. The check follows the program stage by stage from its
own state (the reference cannot follow 1234 bf16 calls from the noise alone):
it replays each stage's sampler on the program's denoiser outputs and
compares the stage's result (``scheduler_gap``); it recomputes the face and
edge dedup masks from the program's boxes (``dedup_mismatch``); at denoiser
calls drawn from the seed it runs the reference denoiser in f32 on the
replayed state and compares the program's output (``denoiser_gap``); and it
decodes the program's final latents (``decode_gap``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from gpubench import counts, trace
from gpubench.kinds.common import (DTYPES, architecture, build, free_cuda, rel_gap, seeds,
                                   worst)
from gpubench.reference import dedup as ref_dedup
from gpubench.reference import denoiser as ref_net
from gpubench.reference import schedulers as ref_sched
from gpubench.reference import vae as ref_vae
from gpubench.reference.precision import exact

STAGES = ("surfpos", "surfz", "edgepos", "edgez")
WARMUP_STEPS = 4  # DDIM steps of the warm-up batch
ATTENTION_KERNELS = ("packed_attention", "set_attention")  # K1/K2, K3 device functions


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


class RecordingNoise:
    """N(0, 1) draws from one generator, kept by (site, step) with ``keep``."""

    def __init__(self, generator: torch.Generator, keep: bool = True):
        self.generator, self.keep = generator, keep
        self.draws: Dict = {}

    def __call__(self, site: str, shape, step: Optional[int] = None) -> torch.Tensor:
        x = torch.randn(tuple(shape), generator=self.generator, device=self.generator.device)
        if self.keep:
            self.draws[(site, step)] = x
        return x


class Run:
    def __init__(self, config: dict, mix: dict, seed: int, device: torch.device):
        self.mix, self.device = mix, device
        self.sampling = config["sampling"]
        self.arch = architecture(config, device)
        self.dtype = DTYPES[self.sampling["dtype"]]
        self.weight_seed, self.check_seed, self.trace_seed = seeds(seed, 3)
        self.batch_seeds = iter(seeds(seed + 1, 4096))
        self.batches: List[dict] = []
        self.rec: Optional[dict] = None

    # --- set-up ------------------------------------------------------------------------
    def setup(self) -> None:
        from brepgen_tpu_torch.cli.build import build_denoiser
        from brepgen_tpu_torch.nn import EdgeVAE, SurfVAE
        from brepgen_tpu_torch.nn.layers import cast_compute
        from brepgen_tpu_torch.sampling import Cascade, CascadeConfig
        from brepgen_tpu_torch.sampling.aot import stage_graphs

        den = self.arch["denoiser"]
        makers = {s: (lambda s=s: build_denoiser(s, False, **den)) for s in STAGES}
        makers["surf_vae"] = lambda: SurfVAE(block_out_channels=tuple(self.arch["surface_vae"]))
        makers["edge_vae"] = lambda: EdgeVAE(block_out_channels=tuple(self.arch["edge_vae"]))
        modules, self.params = build(makers, self.weight_seed, self.device)
        if self.dtype != torch.float32:
            for m in modules.values():
                cast_compute(m, self.dtype)
        s = self.sampling
        self.cfg = CascadeConfig.for_mode(
            s["mode"], batch_size=s["batch_size"], num_surfaces=s["num_surfaces"],
            num_edges=s["num_edges"], bbox_threshold=s["bbox_threshold"],
            z_threshold=s["z_threshold"], pndm_steps=s["pndm_steps"],
            pos_pndm_calls=s["pos_pndm_calls"], ddpm_tail=s["ddpm_tail"],
            fast_steps=self.mix["fast_steps"])
        nets = {k: modules[k] for k in STAGES}
        graphs = stage_graphs(self.device)
        self.cascade = Cascade(nets, modules["surf_vae"], modules["edge_vae"], self.cfg,
                               graphs=graphs)
        warm = Cascade(nets, modules["surf_vae"], modules["edge_vae"],
                       dataclasses.replace(self.cfg, fast_steps=WARMUP_STEPS), graphs=graphs)
        warm.captured = self.cascade.captured  # one store of graphs: the window captures none
        warm(RecordingNoise(torch.Generator(device=self.device).manual_seed(self.trace_seed)))
        self._record_into(self.cascade)

    def _record_into(self, c) -> None:
        """Keep what each stage returns and every denoiser output, as the
        scheduler receives them, in ``self.rec``; each stage is a span. A
        batch that is not checked (``self.rec["keep"]`` false) keeps only
        the outputs' shapes, so that it allocates no more than the program."""
        for name in ("s_surfpos", "s_surfz", "s_edgepos", "s_edgez", "s_decode"):
            def stage(*a, _f=getattr(c, name), _n=name[2:], **k):
                with trace.span(f"cascade.{_n}"):
                    out = _f(*a, **k)
                if self.rec["keep"]:
                    self.rec["out"][_n] = out
                return out
            setattr(c, name, stage)
        stage_eps = c.stage_eps

        def recording_eps(stage, *a, **k):
            eps = stage_eps(stage, *a, **k)
            log = self.rec["eps"].setdefault(stage, [])

            def call(x, t):
                out = eps(x, t)
                log.append(out if self.rec["keep"] else out.shape)
                return out
            return call
        c.stage_eps = recording_eps

    def _batch(self, seed: int, keep: bool = True) -> dict:
        c = self.cascade
        self.rec = rec = {"out": {}, "eps": {}, "stage_times": {}, "keep": keep}
        noise = RecordingNoise(torch.Generator(device=self.device).manual_seed(seed), keep)
        rec["noise"] = noise.draws
        rec["final"] = c(noise, stage_times=rec["stage_times"])
        self.rec = None
        return rec

    # --- the window ---------------------------------------------------------------------
    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        while not self.batches or time.perf_counter() - t0 < seconds:
            self.batches.append(self._batch(next(self.batch_seeds)))
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        B = self.cfg.batch_size
        failed = 0
        for rec in self.batches:
            f = rec["final"]
            ok = torch.ones(B, dtype=torch.bool, device=self.device)
            for k in ("surf_pos", "surf_z", "surf_ncs", "edge_pos", "edge_z", "edge_v",
                      "edge_ncs"):
                ok &= torch.isfinite(f[k].float()).reshape(B, -1).all(dim=1)
            failed += int((~ok).sum())
        attempted = B * len(self.batches)
        return {
            "metrics": {"breps_per_min": attempted / elapsed * 60.0},
            "attempted": attempted,
            "failed": failed,
            "records": {
                "window_s": elapsed,
                "batches": len(self.batches),
                "stage_times": [rec["stage_times"] for rec in self.batches],
                "model_flops": sum(self._flops(rec) for rec in self.batches),
                "dtype": "bf16" if self.dtype == torch.bfloat16 else "f32",
            },
        }

    def _flops(self, rec: dict) -> int:
        d = self.arch["denoiser"]
        total = 0
        for stage, outs in rec["eps"].items():
            for e in outs:
                total += counts.denoiser_flops_per_eval(
                    e.shape[0], e.shape[1], counts.STAGE_STREAMS[stage], counts.STAGE_OUT[stage],
                    d["width"], d["ffn_width"], d["num_layers"])
        return total

    def traced(self) -> dict:
        """One more batch under the profiler, which keeps only the shapes of
        its denoiser outputs; the attention forward's work of its edge calls
        beside the trace."""
        rec, summary = trace.traced(lambda: self._batch(self.trace_seed, keep=False))
        d = self.arch["denoiser"]
        dtype = "bf16" if self.dtype == torch.bfloat16 else "f32"
        ops = nbytes = 0
        for stage in ("edgepos", "edgez"):
            for shape in rec["eps"][stage]:
                o, b = counts.attention_fwd(shape[0], shape[1], d["width"], dtype)
                ops += o * d["num_layers"]
                nbytes += b * d["num_layers"]
        summary["work"] = {"attn_fwd_ops": ops, "attn_fwd_bytes": nbytes, "dtype": dtype,
                           "attention_kernels": ATTENTION_KERNELS}
        return summary

    def release(self) -> None:
        self.cascade = None
        free_cuda()

    # --- the check ----------------------------------------------------------------------
    def readings(self, control: bool = False) -> dict:
        """The four numbers compared. With ``control`` the reference, one
        precision below the configuration's, stands in the program's place:
        fp8 products in the denoiser calls and the decode, the samplers'
        state in bf16 (the configuration keeps it in f32, as diffusers
        does), dedup on bf16 boxes."""
        rng = np.random.default_rng(self.check_seed)
        k = int(self.mix["check_calls"])
        picks = {}
        for stage in STAGES:
            calls = [(b, i) for b, rec in enumerate(self.batches)
                     for i in range(len(rec["eps"].get(stage, [])))]
            chosen = rng.choice(len(calls), size=min(k, len(calls)), replace=False)
            picks[stage] = [calls[j] for j in chosen]
        out = {"denoiser_gap": 0.0, "scheduler_gap": 0.0, "dedup_mismatch": 0.0,
               "decode_gap": 0.0}
        with exact("f32"), torch.no_grad():
            for b, rec in enumerate(self.batches):
                mine = {s: [i for bb, i in picks[s] if bb == b] for s in STAGES}
                jobs = self._follow(rec, mine, out, control)
                for job in jobs:
                    gap = self._denoiser_gap(job, control)
                    out["denoiser_gap"] = worst(out["denoiser_gap"], gap)
                out["decode_gap"] = worst(out["decode_gap"], self._decode_gap(rec, control))
        return out

    def _follow(self, rec: dict, picks: Dict[str, list], out: dict, control: bool) -> list:
        """Replay every stage from the program's state; update the scheduler
        and dedup readings; return the denoiser calls to check, each with
        the replayed state and the stage's conditioning. With ``control``
        the sampler keeps its state in bf16 and dedup reads bf16 boxes, in
        the program's place."""
        cfg, draws, got, eps = self.cfg, rec["noise"], rec["out"], rec["eps"]
        B, ne = cfg.batch_size, cfg.num_edges
        fast = cfg.fast_steps

        def replay(stage, record):
            outs, want = eps.get(stage, []), set(picks[stage]) if record else set()
            state = {"i": 0, "seen": []}

            def fn(x, t):
                i = state["i"]
                state["i"] += 1
                if i >= len(outs):
                    raise IndexError(f"{stage}: the program made {len(outs)} calls")
                if i in want:
                    state["seen"].append((x.clone(), int(t), outs[i]))
                return outs[i].reshape(x.shape)
            return fn, state

        def follow(stage, sample, program):
            """(scheduler reading, replayed calls to check) of one stage;
            ``sample(eps_fn, state)`` runs its sampler."""
            fn, st = replay(stage, True)
            try:
                x = sample(fn, ref_sched._same)
            except IndexError:
                return float("inf"), []
            if st["i"] != len(eps.get(stage, [])):
                return float("inf"), []
            if control:
                program = sample(replay(stage, False)[0], _bf16)
            return rel_gap(program, x), st["seen"]

        def keep(boxes, face_keep=None):
            boxes = _bf16(boxes) if control else boxes
            if face_keep is None:
                return ref_dedup.keep_boxes(boxes, cfg.bbox_threshold)
            return ref_dedup.keep_edges(boxes, face_keep, cfg.bbox_threshold)

        def surfpos(fn, state):
            x = draws[("surfpos", None)]
            if fast:
                n_hi = max(fast * 3 // 4, 1)
                x = ref_sched.ddim(fn, x, fast, calls=n_hi, clip=cfg.ddpm_clip, state=state)
                tail = max(int(ref_sched.ddim_timesteps(fast)[n_hi - 1]), 1)
            else:
                x = ref_sched.pndm(fn, x, cfg.pndm_steps, cfg.pos_pndm_calls, state=state)
                tail = cfg.ddpm_tail
            x = torch.cat([x, x], dim=1)
            return ref_sched.ddpm(fn, x, tail, lambda i, s: draws[("surfpos_ddpm", i)],
                                  cfg.ddpm_clip, state=state)

        def surfz(fn, state):
            z = draws[("surfz", None)]
            return (ref_sched.ddim(fn, z, fast, state=state) if fast
                    else ref_sched.pndm(fn, z, cfg.pndm_steps, state=state))

        def edgepos(fn, state):
            x = draws[("edgepos", None)]
            if fast:
                return ref_sched.ddim(fn, x, fast, clip=cfg.ddpm_clip, state=state)
            x = ref_sched.pndm(fn, x, cfg.pndm_steps, cfg.pos_pndm_calls, state=state)
            return ref_sched.ddpm(fn, x, cfg.ddpm_tail, lambda i, s: draws[("edgepos_ddpm", i)],
                                  cfg.ddpm_clip, state=state)

        def edgez(fn, state):
            z = draws[("edgez", None)]
            z = (ref_sched.ddim(fn, z, fast, state=state) if fast
                 else ref_sched.pndm(fn, z, cfg.pndm_steps, state=state))
            return torch.where(edge_mask[..., None], 0.0, z)

        jobs, gaps = [], []
        surfpos_p = got["surfpos"]
        g, seen = follow("surfpos", surfpos, surfpos_p)
        gaps.append(g)
        jobs += [("surfpos", x, t, e, {"surfpos": x}, None) for x, t, e in seen]

        sp, surf_mask, surf_keep, z_p = got["surfz"]
        want = ref_dedup.keep_boxes(surfpos_p, cfg.bbox_threshold)
        out["dedup_mismatch"] += float((want != (keep(surfpos_p) if control else surf_keep)).sum())
        g, seen = follow("surfz", surfz, z_p)
        gaps.append(g)
        jobs += [("surfz", x, t, e, {"surfz": x, "surfpos": sp}, surf_mask) for x, t, e in seen]

        ns = sp.shape[1]

        def bcast(a):
            return a[:, :, None, :].expand(B, ns, ne, a.shape[-1]).reshape(B, ns * ne, -1)

        def flat(a):
            return a.reshape(B, ns * ne, a.shape[-1])

        edgepos_p = got["edgepos"]
        g, seen = follow("edgepos", edgepos, edgepos_p)
        gaps.append(g)
        jobs += [("edgepos", flat(x), t, e,
                  {"edgepos": flat(x), "surfpos": bcast(sp), "surfz": bcast(z_p)},
                  surf_mask.repeat_interleave(ne, dim=1)) for x, t, e in seen]

        edge_mask, zv_p = got["edgez"]
        want = ref_dedup.keep_edges(edgepos_p, surf_keep, cfg.bbox_threshold)
        have = keep(edgepos_p, surf_keep) if control else ~edge_mask
        out["dedup_mismatch"] += float((want != have).sum())
        g, seen = follow("edgez", edgez, zv_p)
        gaps.append(g)
        jobs += [("edgez", flat(x), t, e,
                  {"edgez": flat(x)[..., :12], "vertpos": flat(x)[..., 12:],
                   "edgepos": flat(edgepos_p), "surfpos": bcast(sp), "surfz": bcast(z_p)},
                  edge_mask.reshape(B, ns * ne)) for x, t, e in seen]
        out["scheduler_gap"] = worst(out["scheduler_gap"], *gaps)
        return jobs

    def _denoiser_gap(self, job, control: bool) -> float:
        stage, x, t, eps_p, streams, pad = job
        d = self.arch["denoiser"]
        p = self.params[stage]
        ref = ref_net.denoise(p, stage, streams, t, pad, d["num_heads"], d["num_layers"], "f32")
        if control:
            eps_p = ref_net.denoise(p, stage, streams, t, pad, d["num_heads"], d["num_layers"],
                                    "fp8")
        valid = None if pad is None else ~pad
        return rel_gap(eps_p.reshape(ref.shape), ref, valid)

    def _decode_gap(self, rec: dict, control: bool) -> float:
        cfg = self.cfg
        B, ne = cfg.batch_size, cfg.num_edges
        _, _, _, z = rec["out"]["surfz"]
        _, zv = rec["out"]["edgez"]
        surf_p, edge_p = rec["out"]["decode"]
        ns = z.shape[1]
        sv, ev = self.params["surf_vae"], self.params["edge_vae"]
        sc, ec = self.arch["surface_vae"], self.arch["edge_vae"]
        zs = z.reshape(B * ns, 4, 4, 3)
        ze = zv[..., :12].reshape(B * ns * ne, 4, 3)

        def surf(prec):
            return ref_vae.chunked(lambda a: ref_vae.surf_decode(sv, a, sc, prec), zs, 256)

        def edge(prec):
            return ref_vae.chunked(lambda a: ref_vae.edge_decode(ev, a, ec, prec), ze, 4096)

        ref_s, ref_e = surf("f32"), edge("f32")
        if control:
            surf_p, edge_p = surf("fp8"), edge("fp8")
        return worst(rel_gap(surf_p.reshape(ref_s.shape), ref_s),
                     rel_gap(edge_p.reshape(ref_e.shape), ref_e))
