"""The four cascaded denoisers as one parameterised transformer.

Port of ``brepgen_tpu/nn/denoiser.py``: per-stream MLP embedders summed with
a sinusoidal time embedding (and a class embedding when class-conditional),
the set transformer, and an MLP head whose output is f32.

Stream layouts (B = batch, nf = max faces, ne = max edges/face):
  surfpos: streams (surfpos[B,nf,6])                          -> eps[B,nf,6]
  surfz:   streams (surfz[B,nf,48], surfpos[B,nf,6])          -> eps[B,nf,48]
  edgepos: streams (edgepos, surfpos*, surfz*) [B,nf*ne,...]  -> eps[B,nf*ne,6]
  edgez:   streams (edgez, vertpos, edgepos, surfpos*, surfz*)-> eps[B,nf*ne,18]
(* broadcast from faces to edges)
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from brepgen_tpu_torch.nn.layers import MLPEmbedder, sincos_embedding
from brepgen_tpu_torch.nn.transformer import TransformerEncoder


def broadcast_face_to_edge(x: torch.Tensor, num_edges: int) -> torch.Tensor:
    """[B, nf, d] -> [B, nf*ne, d] by repeating each face token per edge slot."""
    B, nf, d = x.shape
    return x[:, :, None, :].expand(B, nf, num_edges, d).reshape(B, nf * num_edges, d)


def flatten_face_edge(x: torch.Tensor) -> torch.Tensor:
    """[B, nf, ne, d] -> [B, nf*ne, d]."""
    B, nf, ne, d = x.shape
    return x.reshape(B, nf * ne, d)


class DenoiserTransformer(nn.Module):
    def __init__(self, stream_dims: Tuple[int, ...], stream_names: Tuple[str, ...],
                 out_dim: int, use_cf: bool = False, num_classes: int = 11,
                 width: int = 768, num_heads: int = 12, ffn_width: int = 1024,
                 num_layers: int = 12, attn_impl: str = "plain"):
        super().__init__()
        self.stream_dims = dict(zip(stream_names, stream_dims))
        self.stream_names = tuple(stream_names)
        self.width = width
        self.use_cf = use_cf
        for name, dim in self.stream_dims.items():
            setattr(self, f"{name}_embed", MLPEmbedder(dim, width))
        self.time_embed = MLPEmbedder(width, width)
        if use_cf:
            self.class_embed = nn.Embedding(num_classes, width)
        self.encoder = TransformerEncoder(width, num_heads, ffn_width, num_layers, attn_impl)
        self.head = MLPEmbedder(width, width, out_dim)

    @property
    def dtype(self) -> torch.dtype:
        return self.time_embed.fc1.weight.dtype

    def embed_streams(self, named_streams: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Sum the embedder outputs of the given (sub)set of streams."""
        tokens = 0.0
        for name, s in named_streams.items():
            if s.shape[-1] != self.stream_dims[name]:
                raise ValueError(f"stream {name}: {tuple(s.shape)}")
            tokens = tokens + getattr(self, f"{name}_embed")(s.to(self.dtype))
        return tokens

    def denoise(self, noisy_streams: Dict[str, torch.Tensor], timesteps,
                cond_embed: Optional[torch.Tensor] = None,
                key_padding_mask: Optional[torch.Tensor] = None,
                class_label: Optional[torch.Tensor] = None) -> torch.Tensor:
        tokens = self.embed_streams(noisy_streams)
        B = tokens.shape[0]
        if cond_embed is not None:
            tokens = tokens + cond_embed
        t = torch.as_tensor(timesteps, device=tokens.device).reshape(-1).expand(B)
        t_emb = self.time_embed(sincos_embedding(t, self.width).to(self.dtype))
        tokens = tokens + t_emb[:, None, :]
        if self.use_cf:
            tokens = tokens + self.class_embed(class_label.reshape(B))[:, None, :]
        return self.head(self.encoder(tokens, key_padding_mask)).float()

    def forward(self, streams: Sequence[torch.Tensor], timesteps, key_padding_mask=None,
                class_label=None) -> torch.Tensor:
        named = dict(zip(self.stream_names, streams))
        return self.denoise(named, timesteps, None, key_padding_mask, class_label)


def make_surfpos_net(use_cf: bool = False, **kw) -> DenoiserTransformer:
    return DenoiserTransformer((6,), ("surfpos",), 6, use_cf=use_cf, **kw)


def make_surfz_net(use_cf: bool = False, **kw) -> DenoiserTransformer:
    return DenoiserTransformer((48, 6), ("surfz", "surfpos"), 48, use_cf=use_cf, **kw)


def make_edgepos_net(use_cf: bool = False, **kw) -> DenoiserTransformer:
    return DenoiserTransformer((6, 6, 48), ("edgepos", "surfpos", "surfz"), 6,
                               use_cf=use_cf, **kw)


def make_edgez_net(use_cf: bool = False, **kw) -> DenoiserTransformer:
    return DenoiserTransformer((12, 6, 6, 6, 48),
                               ("edgez", "vertpos", "edgepos", "surfpos", "surfz"), 18,
                               use_cf=use_cf, **kw)
