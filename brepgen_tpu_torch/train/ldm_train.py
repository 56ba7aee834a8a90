"""LDM training steps for the four cascaded denoisers.

Port of ``brepgen_tpu/train/ldm_train.py``. Each step:
  * encodes the conditioning geometry with the frozen VAEs (posterior mode,
    reference ``trainer.py:519-524,919-929``), unless the batch carries the
    latents ("surfz" [B, nf, 48], "edgez" [B, nf, ne, 12]);
  * re-noises the conditioning tensors at t ~ U[0, 15) (condition
    augmentation, ``ldm_train.py:41-48``);
  * noises the target at t ~ U[0, 1000) and takes the eps-prediction loss,
    masked by the stage's key-padding mask (``ldm_train.py:171-173,233-235``);
  * takes one optimizer step (global-norm clip, AdamW).

Torch cannot replay JAX's PRNG, so a step takes its draws (t, noise, the
augmentation t and noise, the CFG label draws) from ``draw_step`` on a
``torch.Generator``, or from the caller (``draws``); dropout masks come from
the same generator. ``compute_dtype=torch.bfloat16`` runs the encodes and the
denoiser under ``torch.autocast`` (bf16 compute over f32 parameters and
optimizer state, as the JAX ``--bf16``); losses are taken in f32.

Each step is a span ``brepgen.train.step`` (id ``step``, the state's count of
steps before it) with the children ``brepgen.train.encode`` (the frozen
encodes), ``.forward`` (from there to the losses: draws, augmentation,
noising and the denoiser), ``.backward`` and ``.optimizer`` (the clip and
AdamW), each with CUDA events on a card (``utils/profiling.py``).

Under data parallelism (``row_split``, a ``parallel.distributed.RowSplit``)
the batch holds this rank's rows of the global batch: the step draws what
the global batch draws and keeps its rows, its masked losses are the global
batch's (``common.masked_mse``) and the metrics it returns are global, so
the ranks together take the single-process step. ``model`` is then the
``DistributedDataParallel`` wrapper, which averages the gradients.

Batch convention: dict of tensors on the training device with keys (per
stage) surfpos [B,nf,6], surfpnt [B,nf,32,32,3], surf_mask [B,nf],
edgepos [B,nf,ne,6], edgepnt [B,nf,ne,32,3], edge_mask [B,nf,ne],
vertpos [B,nf,ne,6], class_label [B,1] (optional).
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Dict, Optional, Sequence

import torch

from brepgen_tpu_torch.diffusion.ddpm import DDPMTables, add_noise
from brepgen_tpu_torch.nn.denoiser import broadcast_face_to_edge, flatten_face_edge
from brepgen_tpu_torch.train.common import TrainState, global_mean, masked_mse
from brepgen_tpu_torch.utils import profiling

AUG_MAX_T = 15
TARGET_DIMS = {"surfpos": 6, "surfz": 48, "edgepos": 6, "edgez": 18}
VAL_STEPS_SURF = (10, 50, 100, 200, 500)
VAL_STEPS_EDGE = (10, 50, 100)

Draws = Dict[str, object]


def draw_step(generator: torch.Generator, tables: DDPMTables, target_shape: Sequence[int],
              aug_shapes: Sequence[Sequence[int]], use_cf: bool) -> Draws:
    """One step's draws on the CPU: "t" [B] in [0, 1000), "noise" N(0, 1) of
    the target's shape, "aug" a (t [B] in [0, 15), noise) pair per
    conditioning tensor, and "cfg_u" [B] U(0, 1) for the label dropout."""
    B = target_shape[0]
    draws = {
        "t": torch.randint(0, tables.num_train_timesteps, (B,), generator=generator),
        "noise": torch.randn(tuple(target_shape), generator=generator),
        "aug": [(torch.randint(0, AUG_MAX_T, (B,), generator=generator),
                 torch.randn(tuple(shape), generator=generator)) for shape in aug_shapes],
    }
    if use_cf:
        draws["cfg_u"] = torch.rand((B,), generator=generator)
    return draws


def take_rows(draws: Draws, row_split) -> Draws:
    """This rank's rows of every draw of ``draw_step``."""
    out = {k: row_split.take(v) for k, v in draws.items() if k != "aug"}
    out["aug"] = [(row_split.take(t), row_split.take(n)) for t, n in draws["aug"]]
    return out


def target_shape(stage: str, rows: int, max_face: int, max_edge: int):
    """The shape of the noised target of ``stage`` for ``rows`` samples."""
    if stage.startswith("surf"):
        return (rows, max_face, TARGET_DIMS[stage])
    return (rows, max_face, max_edge, TARGET_DIMS[stage])


def autocast(device: torch.device, compute_dtype: Optional[torch.dtype]):
    """bf16 compute over f32 parameters, or nothing for f32."""
    if compute_dtype is None or compute_dtype == torch.float32:
        return contextlib.nullcontext()
    return torch.autocast(device.type, dtype=compute_dtype)


def encode_surf(surf_encode: Callable, surfpnt: torch.Tensor) -> torch.Tensor:
    """[B, nf, 32, 32, 3] -> [B, nf, 48] through the frozen surface VAE."""
    B, nf = surfpnt.shape[:2]
    return surf_encode(surfpnt.reshape(B * nf, 32, 32, 3)).reshape(B, nf, 48)


def encode_edge(edge_encode: Callable, edgepnt: torch.Tensor) -> torch.Tensor:
    """[B, nf, ne, 32, 3] -> [B, nf, ne, 12] through the frozen edge VAE."""
    B, nf, ne = edgepnt.shape[:3]
    return edge_encode(edgepnt.reshape(B * nf * ne, 32, 3)).reshape(B, nf, ne, 12)


def _latents(batch, surf_encode=None, edge_encode=None):
    """(surfz, edgez): the batch's latents where it carries them, else the
    frozen encodes of its grids; None where it has neither."""
    with profiling.span("brepgen.train.encode", device=True):
        surfz = batch.get("surfz")
        if surfz is None and "surfpnt" in batch:
            surfz = encode_surf(surf_encode, batch["surfpnt"])
        edgez = batch.get("edgez")
        if edgez is None and "edgepnt" in batch:
            edgez = encode_edge(edge_encode, batch["edgepnt"])
        return surfz, edgez


def _augment(tables: DDPMTables, x: torch.Tensor, draw) -> torch.Tensor:
    """Re-noise one conditioning tensor with its (t, noise) draw."""
    t, noise = draw
    return add_noise(tables, x, noise.to(x.device), t.to(x.device))


def _update(state: TrainState, loss: torch.Tensor) -> None:
    with profiling.span("brepgen.train.backward", device=True):
        loss.backward()
    with profiling.span("brepgen.train.optimizer", device=True):
        state.optimizer.step()
    state.step += 1


def _forward():
    return profiling.span("brepgen.train.forward", device=True)


def _spanned(step):
    """``step`` inside the span ``brepgen.train.step``."""
    @functools.wraps(step)
    def spanned(state: TrainState, batch, generator=None, draws: Optional[Draws] = None):
        with profiling.span("brepgen.train.step", device=True, step=state.step):
            return step(state, batch, generator, draws)

    return spanned


class _Stage:
    """What the four steps share: the frozen encodes, the draws and the
    denoiser call in train mode."""

    def __init__(self, model, tables, surf_encode=None, edge_encode=None, use_cf=False,
                 compute_dtype=None, row_split=None):
        self.model, self.tables = model, tables
        self.surf_encode, self.edge_encode = surf_encode, edge_encode
        self.use_cf, self.compute_dtype = use_cf, compute_dtype
        self.row_split = row_split

    def latents(self, batch):
        device = next(iter(batch.values())).device
        with torch.no_grad(), autocast(device, self.compute_dtype):
            return _latents(batch, self.surf_encode, self.edge_encode)

    def draws(self, draws, generator, target, conds):
        if draws is not None:
            return draws
        split = self.row_split

        def whole(shape):  # the global batch's shape of a rank's tensor
            return shape if split is None else (split.global_rows(shape[0]), *shape[1:])

        draws = draw_step(generator, self.tables, whole(target.shape),
                          [whole(c.shape) for c in conds], self.use_cf)
        return draws if split is None else take_rows(draws, split)

    def mse(self, pred, target, mask):
        return masked_mse(pred, target, mask, self.row_split)

    def metrics(self, **losses):
        return {k: global_mean(v, self.row_split) for k, v in losses.items()}

    def noised(self, x0, draws):
        t = draws["t"].to(x0.device)
        noise = draws["noise"].to(x0.device)
        return add_noise(self.tables, x0, noise, t), noise, t

    def predict(self, streams, t, mask, batch, generator, draws):
        with autocast(t.device, self.compute_dtype):
            return self.model(streams, t, mask, batch.get("class_label"), train=True,
                              generator=generator, label_u=draws.get("cfg_u"))


def make_surfpos_step(model, tables: DDPMTables, use_cf: bool = False, compute_dtype=None,
                      row_split=None):
    st = _Stage(model, tables, use_cf=use_cf, compute_dtype=compute_dtype, row_split=row_split)

    def step(state: TrainState, batch, generator=None, draws: Optional[Draws] = None):
        with _forward():
            x = batch["surfpos"]
            draws = st.draws(draws, generator, x, [])
            x_t, noise, t = st.noised(x, draws)
            pred = st.predict((x_t,), t, None, batch, generator, draws)
            # equal shares: DDP's average is the global mean
            loss = torch.mean((pred - noise) ** 2)
        _update(state, loss)
        return st.metrics(loss=loss)

    return _spanned(step)


def make_surfz_step(model, tables: DDPMTables, surf_encode, use_cf=False, compute_dtype=None,
                    row_split=None):
    st = _Stage(model, tables, surf_encode, use_cf=use_cf, compute_dtype=compute_dtype,
                row_split=row_split)

    def step(state: TrainState, batch, generator=None, draws: Optional[Draws] = None):
        mask = batch["surf_mask"]
        surfz, _ = st.latents(batch)
        with _forward():
            draws = st.draws(draws, generator, surfz, [batch["surfpos"]])
            surfpos = _augment(tables, batch["surfpos"], draws["aug"][0])
            x_t, noise, t = st.noised(surfz, draws)
            pred = st.predict((x_t, surfpos), t, mask, batch, generator, draws)
            loss = st.mse(pred, noise, mask)
        _update(state, loss)
        return st.metrics(loss=loss)

    return _spanned(step)


def make_edgepos_step(model, tables: DDPMTables, surf_encode, use_cf=False, compute_dtype=None,
                      row_split=None):
    st = _Stage(model, tables, surf_encode, use_cf=use_cf, compute_dtype=compute_dtype,
                row_split=row_split)

    def step(state: TrainState, batch, generator=None, draws: Optional[Draws] = None):
        edgepos, mask = batch["edgepos"], batch["surf_mask"]  # [B, nf, ne, 6], [B, nf]
        B, nf, ne, _ = edgepos.shape
        surfz, _ = st.latents(batch)
        with _forward():
            draws = st.draws(draws, generator, edgepos, [batch["surfpos"], surfz])
            surfpos = _augment(tables, batch["surfpos"], draws["aug"][0])
            surfz = _augment(tables, surfz, draws["aug"][1])
            x_t, noise, t = st.noised(edgepos, draws)
            streams = (flatten_face_edge(x_t), broadcast_face_to_edge(surfpos, ne),
                       broadcast_face_to_edge(surfz, ne))
            pred = st.predict(streams, t, mask.repeat_interleave(ne, dim=1), batch, generator,
                              draws).reshape(B, nf, ne, 6)
            # loss over valid faces (all their edge slots), reference trainer.py:732
            loss = st.mse(pred, noise, mask[:, :, None].expand(B, nf, ne))
        _update(state, loss)
        return st.metrics(loss=loss)

    return _spanned(step)


def make_edgez_step(model, tables: DDPMTables, surf_encode, edge_encode, use_cf=False,
                    compute_dtype=None, row_split=None):
    st = _Stage(model, tables, surf_encode, edge_encode, use_cf, compute_dtype, row_split)

    def step(state: TrainState, batch, generator=None, draws: Optional[Draws] = None):
        edgepos, edge_mask = batch["edgepos"], batch["edge_mask"]  # [B,nf,ne,6], [B,nf,ne]
        B, nf, ne, _ = edgepos.shape
        surfz, edgez = st.latents(batch)
        with _forward():
            joint = torch.cat([edgez, batch["vertpos"]], -1)  # [B, nf, ne, 18]
            draws = st.draws(draws, generator, joint, [edgepos, batch["surfpos"], surfz])
            edgepos = _augment(tables, edgepos, draws["aug"][0])
            surfpos = _augment(tables, batch["surfpos"], draws["aug"][1])
            surfz = _augment(tables, surfz, draws["aug"][2])
            x_t, noise, t = st.noised(joint, draws)
            streams = (flatten_face_edge(x_t[..., :12]), flatten_face_edge(x_t[..., 12:]),
                       flatten_face_edge(edgepos), broadcast_face_to_edge(surfpos, ne),
                       broadcast_face_to_edge(surfz, ne))
            pred = st.predict(streams, t, edge_mask.reshape(B, nf * ne), batch, generator,
                              draws).reshape(B, nf, ne, 18)
            loss = st.mse(pred, noise, edge_mask)
            loss_z = st.mse(pred[..., :12], noise[..., :12], edge_mask)
            loss_v = st.mse(pred[..., 12:], noise[..., 12:], edge_mask)
        _update(state, loss)
        return st.metrics(loss=loss, loss_z=loss_z, loss_v=loss_v)

    return _spanned(step)


def make_step(stage: str, model, tables, surf_encode=None, edge_encode=None, use_cf=False,
              compute_dtype=None, row_split=None):
    """The train step of ``stage``."""
    kw = dict(compute_dtype=compute_dtype, row_split=row_split)
    if stage == "surfpos":
        return make_surfpos_step(model, tables, use_cf, **kw)
    if stage == "surfz":
        return make_surfz_step(model, tables, surf_encode, use_cf, **kw)
    if stage == "edgepos":
        return make_edgepos_step(model, tables, surf_encode, use_cf, **kw)
    if stage == "edgez":
        return make_edgez_step(model, tables, surf_encode, edge_encode, use_cf, **kw)
    raise ValueError(stage)


# ---------------------------------------------------------------------------
# validation: masked eps-MSE at fixed timesteps (reference trainer.py:374-408)


def make_val_step(stage: str, model, tables: DDPMTables, surf_encode=None, edge_encode=None,
                  compute_dtype=None):
    """fn(batch, t_fixed, generator=None, noise=None) -> (summed token MSE,
    batch size) as f32 tensors, for averaging over the val set; the noise is
    ``noise`` when given, else from ``generator``. Under data parallelism
    the caller draws the global batch's noise (``target_shape``), hands each
    rank its rows and sums the pairs over the ranks."""

    @torch.no_grad()
    def val(batch, t_fixed: int, generator: Optional[torch.Generator] = None,
            noise: Optional[torch.Tensor] = None):
        device = next(iter(batch.values())).device
        label = batch.get("class_label")
        with autocast(device, compute_dtype):
            surfz, edgez = _latents(batch, surf_encode, edge_encode)
        if stage == "surfpos":
            x = batch["surfpos"]
        elif stage == "surfz":
            x = surfz
        elif stage == "edgepos":
            x = batch["edgepos"]
        elif stage == "edgez":
            x = torch.cat([edgez, batch["vertpos"]], -1)
        else:
            raise ValueError(stage)
        B = x.shape[0]
        t = torch.full((B,), t_fixed, dtype=torch.long, device=device)
        if noise is None:
            noise = torch.randn(x.shape, generator=generator)
        noise = noise.to(device)
        x_t = add_noise(tables, x, noise, t)
        count = torch.tensor(float(B), device=device)
        with autocast(device, compute_dtype):
            if stage == "surfpos":
                pred = model((x_t,), t, None, label)
                return torch.sum(torch.mean((pred - noise) ** 2, dim=(1, 2))), count
            if stage == "surfz":
                mask = batch["surf_mask"]
                pred = model((x_t, batch["surfpos"]), t, mask, label)
                w = (~mask).float()
            else:
                _, nf, ne, d = x.shape
                cond = (broadcast_face_to_edge(batch["surfpos"], ne),
                        broadcast_face_to_edge(surfz, ne))
                if stage == "edgepos":
                    mask = batch["surf_mask"]
                    streams = (flatten_face_edge(x_t),) + cond
                    tok_mask = mask.repeat_interleave(ne, dim=1)
                    w = (~mask)[:, :, None].expand(B, nf, ne).float()
                else:
                    mask = batch["edge_mask"]
                    streams = (flatten_face_edge(x_t[..., :12]), flatten_face_edge(x_t[..., 12:]),
                               flatten_face_edge(batch["edgepos"])) + cond
                    tok_mask = mask.reshape(B, nf * ne)
                    w = (~mask).float()
                pred = model(streams, t, tok_mask, label).reshape(B, nf, ne, d)
        tok_mse = torch.mean((pred - noise) ** 2, dim=-1)
        return torch.sum(tok_mse * w), count

    return val
