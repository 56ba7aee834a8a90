"""One edgez training step of BrepGen's latent diffusion (``trainer.py``,
``train_ldm.sh``), in float32, and the clipped AdamW that takes it.

A step encodes the batch's surface grids and edge curves through the frozen
VAEs (posterior mode), noises the edge latents with the vertices at t ~
U[0, 1000), re-noises the conditioning boxes and surface latents at t ~
U[0, 15), runs the denoiser in train mode (dropout 0.1) and takes the eps
MSE over valid edges; the optimizer clips the gradients to a global norm of
``clip`` (scaled only at or above it) and takes torch's AdamW step.

The step's draws come from a CPU ``torch.Generator`` in the order the
training loop makes them: the timesteps and noise of the target, then a
(timesteps, noise) pair for each conditioning tensor (edge boxes, surface
boxes, surface latents), then one seed per encoder layer for its dropout
masks (``denoiser.encoder``). Each layer is recomputed in the backward to
bound memory; its masks are drawn again from its seed.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.utils.checkpoint

from gpubench.reference import denoiser as net
from gpubench.reference import vae
from gpubench.reference.schedulers import T_TRAIN, add_noise

AUG_MAX_T = 15


def draws(generator: torch.Generator, target_shape, aug_shapes, layers: int) -> Dict:
    B = target_shape[0]
    out = {"t": torch.randint(0, T_TRAIN, (B,), generator=generator),
           "noise": torch.randn(tuple(target_shape), generator=generator),
           "aug": [(torch.randint(0, AUG_MAX_T, (B,), generator=generator),
                    torch.randn(tuple(s), generator=generator)) for s in aug_shapes]}
    out["layer_seeds"] = [int(torch.randint(0, 2 ** 62, (1,), generator=generator))
                          for _ in range(layers)]
    return out


def encode(params: Dict, batch: Dict, surf_channels, edge_channels, prec="f32"):
    """(surfz [B, nf, 48], edgez [B, nf, ne, 12]) of the batch's grids."""
    B, nf, ne = batch["edgepos"].shape[:3]
    with torch.no_grad():
        sz = vae.chunked(lambda a: vae.surf_encode(params["surf_vae"], a, surf_channels, prec),
                         batch["surfpnt"].reshape(B * nf, 32, 32, 3), 512)
        ez = vae.chunked(lambda a: vae.edge_encode(params["edge_vae"], a, edge_channels, prec),
                         batch["edgepnt"].reshape(B * nf * ne, 32, 3), 8192)
    return sz.reshape(B, nf, 48), ez.reshape(B, nf, ne, 12)


def loss_and_grads(p: Dict[str, torch.Tensor], batch: Dict, latents, d: Dict, heads: int,
                   layers: int, dropout: float, prec="f32"):
    """(loss, {name: gradient}) of one step on ``batch`` with draws ``d``."""
    surfz, edgez = latents
    edgepos, mask = batch["edgepos"], batch["edge_mask"]
    B, nf, ne, _ = edgepos.shape
    dev = edgepos.device
    joint = torch.cat([edgez, batch["vertpos"]], -1)
    t = d["t"].to(dev)
    noise = d["noise"].to(dev)
    aug = [(tt.to(dev), n.to(dev)) for tt, n in d["aug"]]
    edgepos = add_noise(edgepos, aug[0][1], aug[0][0])
    surfpos = add_noise(batch["surfpos"], aug[1][1], aug[1][0])
    surfz = add_noise(surfz, aug[2][1], aug[2][0])
    x_t = add_noise(joint, noise, t)

    def bcast(a):
        return a[:, :, None, :].expand(B, nf, ne, a.shape[-1]).reshape(B, nf * ne, -1)

    flat = lambda a: a.reshape(B, nf * ne, a.shape[-1])  # noqa: E731
    streams = {"edgez": flat(x_t[..., :12]), "vertpos": flat(x_t[..., 12:]),
               "edgepos": flat(edgepos), "surfpos": bcast(surfpos), "surfz": bcast(surfz)}
    leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    pad = mask.reshape(B, nf * ne)
    with torch.enable_grad():
        pred = denoise_remat(leaves, streams, t, pad, heads, layers, prec,
                             (d["layer_seeds"], dropout)).reshape(B, nf, ne, 18)
        w = (~mask).float()[..., None]
        loss = (((pred - noise) ** 2) * w).sum() / (w * torch.ones_like(pred)).sum().clamp(min=1)
        names = list(leaves)
        grads = torch.autograd.grad(loss, [leaves[n] for n in names], allow_unused=True)
    return loss.detach(), {n: (torch.zeros_like(p[n]) if g is None else g)
                           for n, g in zip(names, grads)}


def denoise_remat(p, streams, t, pad, heads, layers, prec, drop):
    """``net.denoise`` with each encoder layer recomputed in the backward."""
    tokens = 0.0
    for name in net.STREAMS["edgez"]:
        tokens = tokens + net.mlp_embed(streams[name], p, f"{name}_embed", prec)
    B = tokens.shape[0]
    width = p["time_embed.fc1.weight"].shape[1]
    t = torch.as_tensor(t, device=tokens.device).reshape(-1).expand(B)
    x = tokens + net.mlp_embed(net.sincos(t, width), p, "time_embed", prec)[:, None, :]
    for i in range(layers):
        def layer(x, i=i):
            return net.encoder_layer(x, p, i, heads, pad, prec, drop[0][i], drop[1])
        x = torch.utils.checkpoint.checkpoint(layer, x, use_reentrant=False)
    x = net.layer_norm(x, p, "encoder.final_norm")
    return net.mlp_embed(x, p, "head", prec)


class AdamW:
    """torch's AdamW after the global-norm clip of optax
    (``clip_by_global_norm``): the gradients scaled by clip / norm only when
    norm >= clip. It starts from ``state`` (first and second moments and the
    count of steps taken), or afresh."""

    def __init__(self, params: Dict[str, torch.Tensor], lr, betas, eps, weight_decay, clip,
                 state=None):
        self.p = {k: v.detach().clone() for k, v in params.items()}
        if state is None:
            state = ({k: torch.zeros_like(v) for k, v in self.p.items()},
                     {k: torch.zeros_like(v) for k, v in self.p.items()}, 0)
        m, v, self.k = state
        self.m = {k: m[k].to(self.p[k], copy=True) for k in self.p}
        self.v = {k: v[k].to(self.p[k], copy=True) for k in self.p}
        self.lr, self.betas, self.eps, self.wd, self.clip = lr, betas, eps, weight_decay, clip
        self.k0 = self.k
        self.first: Dict[str, torch.Tensor] = {}

    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        norm = torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads.values())).float()
        if norm >= self.clip:
            grads = {k: g / norm * self.clip for k, g in grads.items()}
        if self.k == self.k0:
            self.first = {k: g.clone() for k, g in grads.items()}
        self.k += 1
        b1, b2 = self.betas
        c1, c2 = 1 - b1 ** self.k, 1 - b2 ** self.k
        for k, g in grads.items():
            p, m, v = self.p[k], self.m[k], self.v[k]
            p.mul_(1 - self.lr * self.wd)
            m.lerp_(g, 1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (v.sqrt() / c2 ** 0.5).add_(self.eps)
            p.addcdiv_(m, denom, value=-self.lr / c1)


def per_leaf_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
                  keep: List[str]) -> Dict[str, float]:
    """Each leaf's gap of norms, | |got| - |want| |, over the larger of the
    leaf's reference norm and the median leaf's; inf where the program has
    no such leaf or reads no number."""
    norms = {k: float(torch.linalg.vector_norm(want[k].double())) for k in keep}
    median = sorted(norms.values())[len(norms) // 2]
    gaps = {}
    for k in keep:
        if k not in got:
            gaps[k] = float("inf")
            continue
        g = float(torch.linalg.vector_norm(got[k].double()))
        gap = abs(g - norms[k]) / max(norms[k], median, 1e-30)
        gaps[k] = float("inf") if gap != gap else gap
    return gaps


def leaf_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
              keep: List[str]) -> float:
    """The worst leaf's gap (``per_leaf_gaps``)."""
    return max(per_leaf_gaps(got, want, keep).values())
