"""Model factories at the widths the repository uses.

``production`` is the full model (``brepgen_tpu/cli/build.py:29-41``,
``nn/denoiser.py:60-66``): denoisers of width 768, 12 heads, 12 layers,
FFN 1024; surface VAE (128, 256, 512, 512); edge VAE (128, 256, 512).
``demo`` is the architecture of the committed trained packs under
``artifacts/demo_round*/*/ckpt_packed/`` (``scripts/train_synthetic_demo.py``):
width 256, 8 heads, 6 layers, FFN 512; VAEs (32, 64, 128, 128) and (32, 64, 128).
"""

from __future__ import annotations

import math
import os
import pickle
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from brepgen_tpu_torch.nn import (
    EdgeVAE,
    SurfVAE,
    make_edgepos_net,
    make_edgez_net,
    make_surfpos_net,
    make_surfz_net,
)
from brepgen_tpu_torch.nn.layers import GroupNorm, LayerNorm

DENOISER_FACTORIES = {
    "surfpos": make_surfpos_net,
    "surfz": make_surfz_net,
    "edgepos": make_edgepos_net,
    "edgez": make_edgez_net,
}

ARCHS = {
    "production": dict(
        denoiser=dict(width=768, num_heads=12, ffn_width=1024, num_layers=12),
        surface=(128, 256, 512, 512),
        edge=(128, 256, 512),
    ),
    "demo": dict(
        denoiser=dict(width=256, num_heads=8, ffn_width=512, num_layers=6),
        surface=(32, 64, 128, 128),
        edge=(32, 64, 128),
    ),
}


def arch_of_packs(weights_dir: str) -> str:
    """The named architecture of the npz packs in ``weights_dir``, read from
    the denoiser width (the input width of the first ``qkv`` projection). The
    head count is not in the weights, so a width that no preset has is
    refused; the strict load then checks every other shape."""
    with np.load(os.path.join(weights_dir, "edgepos.npz")) as pack:
        key = next(k for k in pack.files if k.endswith("layer_0/attn/qkv/kernel"))
        width = pack[key].shape[0]
    for name, arch in ARCHS.items():
        if arch["denoiser"]["width"] == width:
            return name
    raise ValueError(f"{weights_dir}: denoiser width {width} matches no architecture "
                     f"of {sorted(ARCHS)}")


def classes_of_pack(path: str) -> Optional[int]:
    """The class count of a denoiser pack (the rows of its class embedding),
    or None for a pack without one."""
    with np.load(path) as pack:
        key = next((k for k in pack.files if k.endswith("class_embed/embedding")), None)
        return None if key is None else int(pack[key].shape[0])


def vae_channels_of_pack(path: str, option: str) -> Tuple[int, ...]:
    """The block widths of a VAE pack (``option`` "surface" or "edge"), read
    from the output width of the first res block of each encoder level; the
    strict load then checks every other shape."""
    fmt = "encoder/down{}_res0/conv1/kernel" if option == "surface" else \
        "encoder/down{}/res0/conv1/kernel"
    channels = []
    with np.load(path) as pack:
        while True:
            key = next((k for k in pack.files if k.endswith(fmt.format(len(channels)))), None)
            if key is None:
                break
            channels.append(int(pack[key].shape[-1]))
    if not channels:
        raise ValueError(f"{path}: no {option} VAE encoder in the pack")
    return tuple(channels)


def build_denoiser(option: str, use_cf: bool = False, arch: str = "production",
                   **kw) -> nn.Module:
    """The edge stages attend through the CUDA kernel, the short surf stages
    through plain ops (as the JAX sampler routes them to Pallas and XLA)."""
    kw.setdefault("attn_impl", "kernel" if option.startswith("edge") else "plain")
    return DENOISER_FACTORIES[option](use_cf=use_cf, **{**ARCHS[arch]["denoiser"], **kw})


def build_vae(option: str, arch: str = "production") -> nn.Module:
    if option == "surface":
        return SurfVAE(block_out_channels=ARCHS[arch]["surface"])
    if option == "edge":
        return EdgeVAE(block_out_channels=ARCHS[arch]["edge"])
    raise ValueError(option)


@torch.no_grad()
def seed_weights(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights from ``generator``: dense and conv weights and biases
    ~ U(+-1/sqrt(fan_in)) (torch's default bound), embeddings ~ N(0, 1),
    norms at scale 1 and bias 0."""
    for m in module.modules():
        if isinstance(m, (LayerNorm, GroupNorm)):
            m.weight.fill_(1.0)
            m.bias.fill_(0.0)
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(generator=generator)
        elif isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=generator)
    return module


def auto_remat(option: str, batch_size: int, max_face: int, max_edge: int) -> bool:
    """Per-layer recompute for production training, as
    ``brepgen_tpu/cli/build.py:auto_remat``: on once B x tokens reaches
    32768 (the edge stages at their reference batch sizes: deepcad edgez at
    B=128, S=600 is 76800), where the saved activations of the 12 layers
    outgrow device memory."""
    tokens = max_face * max_edge if option in ("edgepos", "edgez") else max_face
    return batch_size * tokens >= 32768


def uid_to_path(data_dir: str, uid: str) -> str:
    """DeepCAD/ABC pkls are sharded into 10k-id folders; furniture is flat
    (reference dataset.py:94-100)."""
    try:
        shard = str(math.floor(int(uid.split(".")[0]) / 10000)).zfill(4)
        return os.path.join(data_dir, shard, uid)
    except ValueError:
        return os.path.join(data_dir, uid)


def load_split_list(list_path: str, split: str) -> List[str]:
    with open(list_path, "rb") as f:
        return pickle.load(f)[split]


FURNITURE_LABELS = {
    "bathtub": 0, "bed": 1, "bench": 2, "bookshelf": 3, "cabinet": 4,
    "chair": 5, "couch": 6, "lamp": 7, "sofa": 8, "table": 9,
}


def resolve_samples(data_dir: str, list_path: str,
                    split: str) -> Tuple[List[str], Optional[List[int]]]:
    """(paths, class labels or None): labels only for the furniture layout,
    whose uids are ``<class>/<name>``."""
    paths, labels = [], []
    furniture = False
    for uid in load_split_list(list_path, split):
        paths.append(uid_to_path(data_dir, uid))
        try:
            int(uid.split(".")[0])
            labels.append(-1)
        except ValueError:
            furniture = True
            labels.append(FURNITURE_LABELS[uid.split("/")[0]])
    return paths, (labels if furniture else None)
