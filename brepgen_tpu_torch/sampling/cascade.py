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
surfPos late-increase split and its short DDPM tail). ``compact`` runs the
edge stages on the kept faces only (face-token compaction). Each schedule is
one Python loop; with ``graphs`` each denoiser call in it replays a CUDA
graph of its stage (``sampling/aot.py``). Every noise draw goes through one
noise source, which the caller can replace (the tests hand it the JAX
package's draws). With tracing on (``utils/profiling.py``) each stage, each
denoiser call, each scheduler update between two calls and the face dedup
is a span (``brepgen.cascade.<stage>``, ``.denoise``, ``.update``,
``.dedup``).

Split sampling (the counterpart of the JAX cascade sharded over the mesh's
``data`` axis): under a process group each rank runs a cascade whose
``batch_size`` is its share of the global batch, with a ``row_split``; its
noise source (``RowNoise``) draws every site at the global batch's shape
from the shared seed and keeps the rank's rows, and compaction takes the
largest kept-face count of any rank (one all-reduce), so every rank uses the
bucket, and hence the tail draws, of the single-process batch. The ranks'
rows together are then the single-process batch.
"""

from __future__ import annotations

import dataclasses
import os
import re
import time
from typing import Any, Callable, Dict, Optional

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
from brepgen_tpu_torch.parallel.distributed import all_reduce_max
from brepgen_tpu_torch.sampling.aot import StageGraphs
from brepgen_tpu_torch.sampling.dedup import dedup_bboxes, dedup_edges_per_face
from brepgen_tpu_torch.utils import profiling

TEXT2INT = {
    "uncond": 0, "bathtub": 1, "bed": 2, "bench": 3, "bookshelf": 4,
    "cabinet": 5, "chair": 6, "couch": 7, "lamp": 8, "sofa": 9, "table": 10,
}

# The keys of eval_config_tpu.yaml that sampling reads, per mode. Its
# *_weight keys name orbax directories, which the port does not load (it
# takes npz packs from --weights_dir), and save_folder is the CLI's.
_PRESET = dict(batch_size=16, z_threshold=0.2, bbox_threshold=0.08)
MODE_PRESETS = {
    "abc": dict(num_surfaces=50, num_edges=40, use_cf=False, class_label=[], **_PRESET),
    "deepcad": dict(num_surfaces=30, num_edges=30, use_cf=False, class_label=[], **_PRESET),
    "furniture": dict(num_surfaces=60, num_edges=40, use_cf=True, class_label="chair",
                      **_PRESET),
}
CONFIG_KEYS = tuple(MODE_PRESETS["abc"])


def _yaml_scalar(text: str) -> Any:
    """One scalar or flow list as ``yaml.safe_load`` reads it (YAML 1.1)."""
    text = text.strip()
    if text in ("", "~", "null", "Null", "NULL"):
        return None
    if len(text) > 1 and text[0] in "'\"" and text[-1] == text[0]:
        return text[1:-1]
    if text.startswith("[") and text.endswith("]"):
        inner = text[1:-1].strip()
        return [_yaml_scalar(x) for x in inner.split(",")] if inner else []
    low = text.lower()
    if low in ("true", "yes", "on"):
        return True
    if low in ("false", "no", "off"):
        return False
    for kind in (int, float):
        try:
            return kind(text)
        except ValueError:
            pass
    return text


def read_eval_config(path: str | os.PathLike) -> Dict[str, Dict[str, Any]]:
    """The ``mode: / key: value`` form of ``eval_config_tpu.yaml``, read
    without ``yaml``: {mode: {key: value}}. Comments, blank lines, scalars and
    flow lists; no other YAML."""
    modes: Dict[str, Dict[str, Any]] = {}
    current = None
    with open(path) as f:
        for n, line in enumerate(f, 1):
            body = re.sub(r"(^|\s)#.*", "", line).rstrip()
            if not body.strip():
                continue
            key, sep, value = body.strip().partition(":")
            if not sep:
                raise ValueError(f"{path}:{n}: expected 'key: value', got {line.strip()!r}")
            if not body[0].isspace():
                if value.strip():
                    raise ValueError(f"{path}:{n}: a mode takes its keys on the lines below")
                current = modes.setdefault(key.strip(), {})
            elif current is None:
                raise ValueError(f"{path}:{n}: a key outside any mode")
            else:
                current[key.strip()] = _yaml_scalar(value)
    return modes


def class_label_id(label: Any) -> int:
    """The reference's label rule: a class name maps through TEXT2INT, an
    empty list (no class) is 0; an unknown name raises."""
    if not isinstance(label, str):
        return 0
    if label not in TEXT2INT:
        raise ValueError(f"unknown class_label {label!r}; one of {sorted(TEXT2INT)}")
    return TEXT2INT[label]


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
    # face-token compaction: after face dedup the edge stages run on the kept
    # faces gathered to the front, padded to a bucket that is a multiple of
    # compact_granularity, and scatter back. Trained weights dedup the doubled
    # face set heavily; seeded weights dedup nothing, and then it is a no-op.
    compact: bool = False
    compact_granularity: int = 8

    @classmethod
    def for_mode(cls, mode: str, batch_size: Optional[int] = None,
                 config: Optional[str | os.PathLike] = None, **kw):
        """The preset of ``mode``; the keys of a file of
        ``eval_config_tpu.yaml``'s form (``config``) override it, and
        ``batch_size`` and ``kw`` override both."""
        p = dict(MODE_PRESETS[mode])
        if config is not None:
            modes = read_eval_config(config)
            if mode not in modes:
                raise ValueError(f"{config}: no entry for mode {mode!r}")
            p.update({k: v for k, v in modes[mode].items() if k in CONFIG_KEYS})
        fields = dict(
            batch_size=int(batch_size or p.get("batch_size", 16)),
            num_surfaces=int(p["num_surfaces"]),
            num_edges=int(p["num_edges"]),
            use_cf=bool(p["use_cf"]),
            class_label=class_label_id(p.get("class_label")),
            z_threshold=float(p.get("z_threshold", 0.2)),
            bbox_threshold=float(p.get("bbox_threshold", 0.08)),
        )
        fields.update(kw)
        return cls(**fields)

    @property
    def faces(self) -> int:
        """Face slots after the late increase."""
        return self.num_surfaces if self.use_cf else 2 * self.num_surfaces


def face_gather(surf_keep: torch.Tensor, ns_c: int):
    """(gather, scatter) between all face slots [B, ns, ...] and the first
    ``ns_c`` faces of the stable kept-first order [B, ns_c, ...]; ``scatter(a,
    fill)`` puts ``fill`` in the slots outside the bucket."""
    B, ns = surf_keep.shape
    order = torch.argsort((~surf_keep).to(torch.uint8), dim=1, stable=True)
    rows = torch.arange(B, device=surf_keep.device)[:, None]
    idx = order[:, :ns_c]

    def scatter(a: torch.Tensor, fill) -> torch.Tensor:
        out = torch.full((B, ns, *a.shape[2:]), fill, dtype=a.dtype, device=a.device)
        out[rows, idx] = a
        return out

    return (lambda a: a[rows, idx]), scatter


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


class RowNoise:
    """A noise source for one rank's rows: ``noise`` draws each site at the
    global batch's shape and this rank's rows (``row_split``, a
    ``parallel.distributed.RowSplit`` of equal shares) are returned."""

    def __init__(self, noise: Callable, row_split):
        self.noise, self.row_split = noise, row_split

    def __call__(self, site: str, shape, step: Optional[int] = None) -> torch.Tensor:
        full = (self.row_split.global_rows(shape[0]), *shape[1:])
        return self.row_split.take(self.noise(site, full, step))


class Cascade:
    """``Cascade(nets, surf_vae, edge_vae, config)(noise)`` -> dict of tensors.

    With ``graphs`` (``sampling/aot.py``; the entry points give it one on a
    CUDA card) every denoiser call replays a CUDA graph of its stage,
    captured at its first call; without, it runs eagerly. With ``row_split``
    it is one rank's share of a split batch (the module's docstring); its
    ``batch_size`` is the rank's rows. ``precompile_stage`` and
    ``run_stage_random`` run one stage alone, for the benches."""

    def __init__(self, nets: Dict[str, torch.nn.Module], surf_vae, edge_vae,
                 config: CascadeConfig, graphs: Optional[StageGraphs] = None,
                 row_split=None):
        self.nets = nets
        self.row_split = row_split
        self.surf_vae = surf_vae
        self.edge_vae = edge_vae
        self.cfg = config
        self.graphs = graphs
        self.captured: Dict = {}  # this cascade's graphs, by (stage, signature)
        self.model_calls = dict.fromkeys(STAGES[:4], 0)
        self.batch = -1  # the index of the batch ``__call__`` runs, the spans' ``batch`` id
        self.last_bucket = None  # face slots of the last batch's edge stages
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
        handles CFG batch doubling; replays the stage's graph when the
        cascade has ``graphs``."""
        cfg = self.cfg
        net = self.nets[stage]
        B = cfg.batch_size
        labels = None
        if cfg.use_cf:
            classes = net.class_embed.num_embeddings
            if not 0 <= cfg.class_label < classes:
                raise ValueError(f"class_label {cfg.class_label} is outside the {classes} "
                                 f"classes of the {stage} denoiser")
            cond_named = {k: torch.cat([v, v]) for k, v in cond_named.items()}
            if tok_mask is not None:
                tok_mask = torch.cat([tok_mask, tok_mask])
            labels = torch.cat([
                torch.full((B, 1), cfg.class_label, dtype=torch.long, device=self.device),
                torch.zeros((B, 1), dtype=torch.long, device=self.device),
            ])
        consts = (net.embed_streams(cond_named) if cond_named else None, tok_mask, labels)

        def denoise(x, t, cond_embed, tok_mask, labels):
            noisy = noisy_of(x)
            if cfg.use_cf:
                noisy = {k: torch.cat([v, v]) for k, v in noisy.items()}
            pred = net.denoise(noisy, t, cond_embed, tok_mask, labels)
            if cfg.use_cf:
                w = cfg.cfg_weight
                pred = pred[:B] * (1 + w) - pred[B:] * w
            return pred

        if self.graphs is None:
            run = lambda x, t: denoise(x, t, *consts)  # noqa: E731
        else:
            run = self.graphs.stage(stage, denoise, consts, self.captured, net.dtype)

        def eps(x, t):
            self.model_calls[stage] += 1
            with profiling.span("brepgen.cascade.denoise", batch=self.batch, stage=stage,
                                call=self.model_calls[stage]):
                return run(x, t)

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
        with profiling.span("brepgen.cascade.dedup"):
            surf_keep = dedup_bboxes(surfpos, cfg.bbox_threshold)  # True = keep
        surf_mask = ~surf_keep  # True = pad
        surfpos = torch.where(surf_mask[:, :, None], 0.0, surfpos)
        z = noise("surfz", (cfg.batch_size, cfg.faces, 48))
        eps = self.stage_eps("surfz", lambda x: {"surfz": x}, {"surfpos": surfpos}, surf_mask)
        if self.fast:
            z = ddim_loop(eps, z, self.ddim_plan)
        else:
            z = pndm_loop(eps, z, self.pndm_full_plan)
        return surfpos, surf_mask, surf_keep, z

    def s_edgepos(self, noise, surfpos, surfz, surf_mask, x0=None):
        """Edge boxes for the ``ns`` faces of ``surfpos`` (all face slots, or a
        compacted bucket); ``x0`` is the initial noise, drawn here if None."""
        cfg = self.cfg
        B, ns, ne = cfg.batch_size, surfpos.shape[1], cfg.num_edges
        raw = self.stage_eps(
            "edgepos",
            lambda x: {"edgepos": x},
            {"surfpos": broadcast_face_to_edge(surfpos, ne),
             "surfz": broadcast_face_to_edge(surfz, ne)},
            surf_mask.repeat_interleave(ne, dim=1),
        )
        eps = lambda x, t: raw(flatten_face_edge(x), t).reshape(B, ns, ne, 6)
        x = noise("edgepos", (B, ns, ne, 6)) if x0 is None else x0
        if self.fast:
            return ddim_loop(eps, x, self.ddim_plan, clip_range=cfg.ddpm_clip)
        x = pndm_loop(eps, x, self.pndm_pos_plan)
        return ddpm_loop(eps, x, self.ddpm_plan,
                         lambda i, shape: noise("edgepos_ddpm", shape, i), cfg.ddpm_clip)

    def s_edgez(self, noise, edgepos, surfpos, surfz, surf_keep, z0=None):
        cfg = self.cfg
        B, ns, ne = cfg.batch_size, surfpos.shape[1], cfg.num_edges
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
        z = noise("edgez", (B, ns, ne, 18)) if z0 is None else z0
        if self.fast:
            z = ddim_loop(eps, z, self.ddim_plan)
        else:
            z = pndm_loop(eps, z, self.pndm_full_plan)
        return edge_mask, torch.where(edge_mask[..., None], 0.0, z)

    def compact_bucket(self, surf_keep: torch.Tensor) -> int:
        """Face slots the edge stages run on: every slot, or with ``compact``
        the most kept faces of any sample rounded up to the granularity (a
        host sync; of any rank's sample under a ``row_split``)."""
        cfg = self.cfg
        ns = surf_keep.shape[1]
        if not cfg.compact:
            return ns
        g = cfg.compact_granularity
        count = int(surf_keep.sum(dim=1).max())
        if self.row_split is not None:
            count = all_reduce_max(count, surf_keep.device)
        return min(ns, max(g, -(-count // g) * g))

    def s_decode(self, surfz, edgezv):
        """Decode in bounded chunks (1024 faces, 8192 edges per call)."""
        B, ns, ne = self.cfg.batch_size, self.cfg.faces, self.cfg.num_edges

        def chunked(decode, z, chunk):
            return torch.cat([decode(z[i:i + chunk]) for i in range(0, z.shape[0], chunk)])

        surf_ncs = chunked(self.surf_vae.decode, surfz.reshape(B * ns, 4, 4, 3), 1024)
        edge_ncs = chunked(self.edge_vae.decode, edgezv[..., :12].reshape(B * ns * ne, 4, 3), 8192)
        return surf_ncs.reshape(B, ns, 32, 32, 3), edge_ncs.reshape(B, ns, ne, 32, 3)

    # --- bench hooks (brepgen_tpu/sampling/cascade.py:579-637) ---------------
    def stage_inputs(self, name: str, ns_c: Optional[int] = None):
        """The shapes of the inputs a bench hook hands stage ``name``, in the
        order of JAX's draws (``cascade.py:622-633``): the edge stages run on
        ``ns_c`` face slots where given, the others on every slot."""
        if name not in STAGES:
            raise ValueError(f"unknown stage {name!r}; one of {STAGES}")
        cfg = self.cfg
        B, ns, ne = cfg.batch_size, cfg.faces, cfg.num_edges
        nsx = ns if ns_c is None else ns_c
        return {
            "surfpos": (),
            "surfz": ((B, ns, 6),),
            "edgepos": ((B, nsx, 6), (B, nsx, 48)),
            "edgez": ((B, nsx, ne, 6), (B, nsx, 6), (B, nsx, 48)),
            "decode": ((B, ns, 48), (B, ns, ne, 18)),
        }[name]

    def _run_stage(self, name: str, noise, inputs, face_flags: bool):
        """Stage ``name`` on ``inputs``; the edge stages take a face mask of
        ``face_flags`` (edgepos its ``surf_mask``, edgez its ``surf_keep``)."""
        if name == "decode":
            return self.s_decode(*inputs)
        if name in ("edgepos", "edgez"):
            flags = torch.full(inputs[0].shape[:2], face_flags, dtype=torch.bool,
                               device=self.device)
            inputs = (*inputs, flags)
        return getattr(self, f"s_{name}")(noise, *inputs)

    @torch.inference_mode()
    def precompile_stage(self, name: str) -> None:
        """Run stage ``name`` once on zero-filled inputs of the production
        shapes, as JAX's ``precompile_stage`` does (its masks are zeros too):
        on the card this captures the stage's CUDA graphs (and writes their
        manifest where the cascade's ``StageGraphs`` has a cache directory);
        on the CPU it runs eagerly."""
        gen = torch.Generator(device=self.device).manual_seed(0)
        inputs = [torch.zeros(s, device=self.device) for s in self.stage_inputs(name)]
        self._run_stage(name, GeneratorNoise(gen), inputs, False)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def run_stage_random(self, name: str, seed: int, ns_c: Optional[int] = None,
                         inputs=None, noise=None):
        """Stage ``name`` on random inputs of the production shapes, as JAX's
        ``run_stage_random``, on ``ns_c`` face slots for the edge stages (the
        compacted bucket) where given; returns what the stage returns. The
        masks are JAX's: no face masked for edgepos, every face kept for
        edgez.

        The inputs and the stage's own draws come from one ``torch.Generator``
        seeded by ``seed``; ``inputs`` (arrays of the ``stage_inputs``
        shapes) and ``noise`` (a noise source) replace them where given, as
        the tests hand it JAX's draws."""
        shapes = self.stage_inputs(name, ns_c)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        if inputs is None:
            inputs = [torch.randn(s, generator=gen, device=self.device) for s in shapes]
        else:
            inputs = [torch.as_tensor(a, dtype=torch.float32, device=self.device)
                      for a in inputs]
            got = tuple(tuple(a.shape) for a in inputs)
            if got != shapes:
                raise ValueError(f"stage {name}: inputs of shapes {got}, expected {shapes}")
        noise = GeneratorNoise(gen) if noise is None else noise
        return self._run_stage(name, noise, inputs, name == "edgez")

    @torch.inference_mode()
    def __call__(self, noise, stage_times: Optional[Dict[str, float]] = None,
                 after_stage: Optional[Callable[[str], None]] = None) -> Dict[str, torch.Tensor]:
        """One batch. ``stage_times`` collects seconds per stage (synchronising
        the device around each); ``after_stage(name)`` runs after each stage.
        Each stage is a span ``brepgen.cascade.<stage>`` with the batch's
        index (``batch``)."""
        cuda = self.device.type == "cuda"
        self.batch += 1

        def run(name, fn, *args):
            if stage_times is not None and cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            with profiling.span(f"brepgen.cascade.{name}", device=True, batch=self.batch):
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
        ns_c = self.last_bucket = self.compact_bucket(surf_keep)
        if ns_c < cfg.faces:
            # the edge stages on the kept faces; initial noise drawn at the
            # full shape and gathered, so kept-face PNDM and DDIM trajectories
            # equal the uncompacted run's (the DDPM tail draws at the bucket's
            # shape); slots outside the bucket get zeros, all edges masked
            gather, scatter = face_gather(surf_keep, ns_c)
            sp, sz, mask, keep = map(gather, (surfpos, surfz, surf_mask, surf_keep))
            full = (cfg.batch_size, cfg.faces, cfg.num_edges)
            edgepos = run("edgepos", lambda: self.s_edgepos(
                noise, sp, sz, mask, x0=gather(noise("edgepos", (*full, 6)))))
            edge_mask, edgezv = run("edgez", lambda: self.s_edgez(
                noise, edgepos, sp, sz, keep, z0=gather(noise("edgez", (*full, 18)))))
            edgepos, edge_mask, edgezv = (
                scatter(edgepos, 0.0), scatter(edge_mask, True), scatter(edgezv, 0.0))
        else:
            edgepos = run("edgepos", self.s_edgepos, noise, surfpos, surfz, surf_mask)
            edge_mask, edgezv = run("edgez", self.s_edgez, noise, edgepos, surfpos, surfz,
                                    surf_keep)
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
