"""The four-stage generation cascade, stage by stage.

Port of ``brepgen_tpu/sampling/cascade.py``:

  1-1  surfPos:  [B, ns0, 6] ~ N(0,1); 158 PNDM calls (of a 200-step schedule)
       then 250 DDPM steps with x0 clipped to +/-3; CFG w=0.6 by batch
       doubling when class-conditional. Unconditional modes double the face
       set between the phases (the late increase, ns = 2*ns0).
  1-2  face dedup -> keep mask.
  1-3  surfZ:    [B, ns, 48]; the full 200-step PNDM schedule, face-masked.
  2-1  edgePos:  [B, ns, ne, 6]; 158 PNDM + 250 DDPM, face-masked.
  2-2  per-face edge dedup -> edge keep mask.
  2-3  edgeZV:   [B, ns, ne, 18]; full PNDM; masked slots zeroed.
  VAE decode of all face/edge latents in bounded chunks; bboxes divided by 3.

``fast_steps`` > 0 replaces the protocol with N-step DDIM per stage (plus the
surfPos late-increase split and its short DDPM tail). Each schedule is one
Python loop. Every noise draw goes through one noise source, which the caller
can replace (the tests hand it the JAX package's draws).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import torch

from brepgen_tpu_torch.diffusion import (
    ddim_loop,
    ddpm_loop,
    make_ddim_plan,
    make_ddpm_plan,
    make_pndm_plan,
    pndm_loop,
    slice_plan,
)
from brepgen_tpu_torch.nn.denoiser import broadcast_face_to_edge, flatten_face_edge
from brepgen_tpu_torch.sampling.dedup import dedup_bboxes, dedup_edges_per_face

TEXT2INT = {
    "uncond": 0, "bathtub": 1, "bed": 2, "bench": 3, "bookshelf": 4,
    "cabinet": 5, "chair": 6, "couch": 7, "lamp": 8, "sofa": 9, "table": 10,
}

# eval_config.yaml parity (reference eval_config.yaml:1-47)
MODE_PRESETS = {
    "abc": dict(num_surfaces=50, num_edges=40, use_cf=False),
    "deepcad": dict(num_surfaces=30, num_edges=30, use_cf=False),
    "furniture": dict(num_surfaces=60, num_edges=40, use_cf=True),
}

STAGES = ("surfpos", "surfz", "edgepos", "edgez", "decode")


@dataclasses.dataclass(frozen=True)
class CascadeConfig:
    batch_size: int = 16
    num_surfaces: int = 30
    num_edges: int = 30
    use_cf: bool = False
    class_label: int = 0
    cfg_weight: float = 0.6
    z_threshold: float = 0.2
    bbox_threshold: float = 0.08
    bbox_scaled: float = 3.0
    pndm_steps: int = 200
    pos_pndm_calls: int = 158
    ddpm_tail: int = 250
    ddpm_clip: float = 3.0
    fast_steps: int = 0  # > 0: N-step DDIM per stage instead of the protocol

    @classmethod
    def for_mode(cls, mode: str, batch_size: int = 16, class_label: str = "uncond", **kw):
        p = MODE_PRESETS[mode]
        return cls(
            batch_size=batch_size,
            num_surfaces=p["num_surfaces"],
            num_edges=p["num_edges"],
            use_cf=p["use_cf"],
            class_label=TEXT2INT.get(class_label, 0) if p["use_cf"] else 0,
            **kw,
        )

    @property
    def faces(self) -> int:
        """Face slots after the late increase."""
        return self.num_surfaces if self.use_cf else 2 * self.num_surfaces


class GeneratorNoise:
    """The default noise source: N(0, 1) draws from one ``torch.Generator``.

    A noise source is called as ``noise(site, shape, step)``: ``site`` names
    the draw ("surfpos", "surfpos_ddpm", "surfz", "edgepos", "edgepos_ddpm",
    "edgez"), ``step`` is the DDPM step for the per-step draws, else None.
    """

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def __call__(self, site: str, shape, step: Optional[int] = None) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.generator, device=self.generator.device)


class Cascade:
    """``Cascade(nets, surf_vae, edge_vae, config)(noise)`` -> dict of tensors."""

    def __init__(self, nets: Dict[str, torch.nn.Module], surf_vae, edge_vae,
                 config: CascadeConfig):
        self.nets = nets
        self.surf_vae = surf_vae
        self.edge_vae = edge_vae
        self.cfg = config
        self.model_calls = dict.fromkeys(STAGES[:4], 0)
        cfg = config
        if cfg.fast_steps > 0:
            self.ddim_plan = make_ddim_plan(cfg.fast_steps)
            # surfpos late-increase split: DDIM down to an intermediate t,
            # duplicate the set, then a stochastic DDPM tail
            n_hi = max(cfg.fast_steps * 3 // 4, 1)
            self.ddim_plan_hi = slice_plan(self.ddim_plan, n_hi)
            self.ddpm_tail_plan = make_ddpm_plan(num_steps=max(int(self.ddim_plan_hi.t[-1]), 1))
        else:
            self.pndm_pos_plan = make_pndm_plan(cfg.pndm_steps, max_calls=cfg.pos_pndm_calls)
            self.pndm_full_plan = make_pndm_plan(cfg.pndm_steps)
            self.ddpm_plan = make_ddpm_plan(num_steps=cfg.ddpm_tail)

    @property
    def fast(self) -> bool:
        return self.cfg.fast_steps > 0

    @property
    def device(self) -> torch.device:
        return next(self.surf_vae.parameters()).device

    def stage_eps(self, stage: str, noisy_of: Callable, cond_named: Dict[str, torch.Tensor],
                  tok_mask: Optional[torch.Tensor]) -> Callable:
        """eps(x, t) with the constant conditioning streams embedded once;
        handles CFG batch doubling."""
        cfg = self.cfg
        net = self.nets[stage]
        B = cfg.batch_size
        labels = None
        if cfg.use_cf:
            cond_named = {k: torch.cat([v, v]) for k, v in cond_named.items()}
            if tok_mask is not None:
                tok_mask = torch.cat([tok_mask, tok_mask])
            labels = torch.cat([
                torch.full((B, 1), cfg.class_label, dtype=torch.long, device=self.device),
                torch.zeros((B, 1), dtype=torch.long, device=self.device),
            ])
        cond_embed = net.embed_streams(cond_named) if cond_named else None

        def eps(x, t):
            self.model_calls[stage] += 1
            noisy = noisy_of(x)
            if cfg.use_cf:
                noisy = {k: torch.cat([v, v]) for k, v in noisy.items()}
            pred = net.denoise(noisy, t, cond_embed, tok_mask, labels)
            if cfg.use_cf:
                w = cfg.cfg_weight
                pred = pred[:B] * (1 + w) - pred[B:] * w
            return pred

        return eps

    # --- stages -------------------------------------------------------------
    def s_surfpos(self, noise):
        cfg = self.cfg
        eps = self.stage_eps("surfpos", lambda x: {"surfpos": x}, {}, None)
        ddpm_noise = lambda i, shape: noise("surfpos_ddpm", shape, i)
        x = noise("surfpos", (cfg.batch_size, cfg.num_surfaces, 6))
        if self.fast:
            x = ddim_loop(eps, x, self.ddim_plan_hi, clip_range=cfg.ddpm_clip)
            tail = self.ddpm_tail_plan
        else:
            x = pndm_loop(eps, x, self.pndm_pos_plan)
            tail = self.ddpm_plan
        if not cfg.use_cf:
            x = torch.cat([x, x], dim=1)  # late increase
        return ddpm_loop(eps, x, tail, ddpm_noise, cfg.ddpm_clip)

    def s_surfz(self, noise, surfpos):
        cfg = self.cfg
        surf_keep = dedup_bboxes(surfpos, cfg.bbox_threshold)  # True = keep
        surf_mask = ~surf_keep                                  # True = pad
        surfpos = torch.where(surf_mask[:, :, None], 0.0, surfpos)
        z = noise("surfz", (cfg.batch_size, cfg.faces, 48))
        eps = self.stage_eps("surfz", lambda x: {"surfz": x}, {"surfpos": surfpos}, surf_mask)
        if self.fast:
            z = ddim_loop(eps, z, self.ddim_plan)
        else:
            z = pndm_loop(eps, z, self.pndm_full_plan)
        return surfpos, surf_mask, surf_keep, z

    def s_edgepos(self, noise, surfpos, surfz, surf_mask):
        cfg = self.cfg
        B, ns, ne = cfg.batch_size, cfg.faces, cfg.num_edges
        raw = self.stage_eps(
            "edgepos",
            lambda x: {"edgepos": x},
            {"surfpos": broadcast_face_to_edge(surfpos, ne),
             "surfz": broadcast_face_to_edge(surfz, ne)},
            surf_mask.repeat_interleave(ne, dim=1),
        )
        eps = lambda x, t: raw(flatten_face_edge(x), t).reshape(B, ns, ne, 6)
        x = noise("edgepos", (B, ns, ne, 6))
        if self.fast:
            return ddim_loop(eps, x, self.ddim_plan, clip_range=cfg.ddpm_clip)
        x = pndm_loop(eps, x, self.pndm_pos_plan)
        return ddpm_loop(eps, x, self.ddpm_plan,
                         lambda i, shape: noise("edgepos_ddpm", shape, i), cfg.ddpm_clip)

    def s_edgez(self, noise, edgepos, surfpos, surfz, surf_keep):
        cfg = self.cfg
        B, ns, ne = cfg.batch_size, cfg.faces, cfg.num_edges
        edge_mask = ~dedup_edges_per_face(edgepos, surf_keep, cfg.bbox_threshold)
        raw = self.stage_eps(
            "edgez",
            lambda x: {"edgez": x[..., :12], "vertpos": x[..., 12:]},
            {"edgepos": flatten_face_edge(edgepos),
             "surfpos": broadcast_face_to_edge(surfpos, ne),
             "surfz": broadcast_face_to_edge(surfz, ne)},
            edge_mask.reshape(B, ns * ne),
        )
        eps = lambda x, t: raw(x.reshape(B, ns * ne, 18), t).reshape(B, ns, ne, 18)
        z = noise("edgez", (B, ns, ne, 18))
        if self.fast:
            z = ddim_loop(eps, z, self.ddim_plan)
        else:
            z = pndm_loop(eps, z, self.pndm_full_plan)
        return edge_mask, torch.where(edge_mask[..., None], 0.0, z)

    def s_decode(self, surfz, edgezv):
        """Decode in bounded chunks (1024 faces, 8192 edges per call)."""
        B, ns, ne = self.cfg.batch_size, self.cfg.faces, self.cfg.num_edges

        def chunked(decode, z, chunk):
            return torch.cat([decode(z[i:i + chunk]) for i in range(0, z.shape[0], chunk)])

        surf_ncs = chunked(self.surf_vae.decode, surfz.reshape(B * ns, 4, 4, 3), 1024)
        edge_ncs = chunked(self.edge_vae.decode, edgezv[..., :12].reshape(B * ns * ne, 4, 3), 8192)
        return surf_ncs.reshape(B, ns, 32, 32, 3), edge_ncs.reshape(B, ns, ne, 32, 3)

    @torch.inference_mode()
    def __call__(self, noise, stage_times: Optional[Dict[str, float]] = None,
                 after_stage: Optional[Callable[[str], None]] = None) -> Dict[str, torch.Tensor]:
        """One batch. ``stage_times`` collects seconds per stage (synchronising
        the device around each); ``after_stage(name)`` runs after each stage."""
        cuda = self.device.type == "cuda"

        def run(name, fn, *args):
            if stage_times is not None and cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            if stage_times is not None:
                if cuda:
                    torch.cuda.synchronize()
                stage_times[name] = stage_times.get(name, 0.0) + time.perf_counter() - t0
            if after_stage is not None:
                after_stage(name)
            return out

        cfg = self.cfg
        surfpos = run("surfpos", self.s_surfpos, noise)
        surfpos, surf_mask, surf_keep, surfz = run("surfz", self.s_surfz, noise, surfpos)
        edgepos = run("edgepos", self.s_edgepos, noise, surfpos, surfz, surf_mask)
        edge_mask, edgezv = run("edgez", self.s_edgez, noise, edgepos, surfpos, surfz, surf_keep)
        surf_ncs, edge_ncs = run("decode", self.s_decode, surfz, edgezv)
        return {
            "surf_pos": surfpos / cfg.bbox_scaled,
            "surf_mask": surf_mask,
            "surf_z": surfz,
            "surf_ncs": surf_ncs,
            "edge_pos": edgepos / cfg.bbox_scaled,
            "edge_mask": edge_mask,
            "edge_z": edgezv[..., :12],
            "edge_v": edgezv[..., 12:],
            "edge_ncs": edge_ncs,
        }
