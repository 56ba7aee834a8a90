"""Convert reference PyTorch checkpoints (``.pt`` state dicts) into the port.

Port of ``brepgen_tpu/tools/convert_torch.py``: loads the released BrepGen
weights (reference ``README.md:97-102``). The JAX tool turns them into a
flax tree; here they go straight onto the port's modules, whose parameter
names are the flax scopes and whose layouts are torch's, so nothing is
transposed. Source layouts:

  denoisers (reference ``network.py:1066-1393``): MLP stream embedders
  ``{p,z,surfp,surfz,edgep,edgez,vertp}_embed/...`` (Linear, LayerNorm, SiLU,
  Linear), ``time_embed``, ``class_embed.embed``, a ``net`` = torch
  ``nn.TransformerEncoder`` (packed ``in_proj``, pre-LN, ReLU FFN, final
  ``net.norm``), and ``fc_out``;

  surface VAE: diffusers ``AutoencoderKL``; edge VAE: the reference's 1D VAE.

``main`` writes the port's npz pack (``train/checkpoint.py:save_params_npz``),
which ``sample_main --weights_dir`` and the JAX package load:

    python -m brepgen_tpu_torch.tools.convert_torch --input edgez.pt \\
        --kind edgez --output PACKS/edgez.npz

A denoiser's width, FFN width, depth and class count are read from the
state dict; its head count, which a state dict does not hold, is the one of
the port's architecture of that width (``cli/build.py:ARCHS``). A VAE's
block widths are read from its encoder. The state dict is read with
``torch.load(weights_only=True)`` onto the CPU.
"""

from __future__ import annotations

import argparse
import os
import re
from typing import Dict, Mapping

import torch
from torch import nn

from brepgen_tpu_torch.cli.build import ARCHS, build_denoiser
from brepgen_tpu_torch.nn import EdgeVAE, SurfVAE

StateDict = Dict[str, torch.Tensor]

# stream-embedder names per stage: the port's -> the reference state dict's
STREAM_MAPS = {
    "surfpos": {"surfpos_embed": "p_embed"},
    "surfz": {"surfz_embed": "z_embed", "surfpos_embed": "p_embed"},
    "edgepos": {
        "edgepos_embed": "edgep_embed",
        "surfpos_embed": "surfp_embed",
        "surfz_embed": "surfz_embed",
    },
    "edgez": {
        "edgez_embed": "edgez_embed",
        "vertpos_embed": "vertp_fc",
        "edgepos_embed": "edgep_embed",
        "surfpos_embed": "surfp_embed",
        "surfz_embed": "surfz_embed",
    },
}
KINDS = ("surfpos", "surfz", "edgepos", "edgez", "surfvae", "edgevae")


def _strip(sd: Mapping) -> StateDict:
    """Drop DataParallel's ``module.`` prefix; values as f32 CPU tensors."""
    return {k.replace("module.", ""): torch.as_tensor(v).detach().to("cpu", torch.float32)
            for k, v in sd.items()}


def _copy(out: StateDict, sd: StateDict, theirs: str, ours: str, bias: bool = True) -> None:
    """Linear, conv or norm ``theirs`` -> ``ours`` (the same layout)."""
    out[f"{ours}.weight"] = sd[f"{theirs}.weight"]
    if bias:
        out[f"{ours}.bias"] = sd[f"{theirs}.bias"]


def _mlp(out, sd, theirs, ours):
    """Reference embedder / head: Sequential(Linear, LayerNorm, SiLU, Linear)."""
    for i, name in ((0, "fc1"), (1, "norm"), (3, "fc2")):
        _copy(out, sd, f"{theirs}.{i}", f"{ours}.{name}")


def num_encoder_layers(sd: Mapping, layer: str = r"net\.layers\.") -> int:
    """The layers of an encoder whose layer ``i``'s keys start ``<layer>i.``
    (the reference's ``net.layers.``; the port's ``encoder.layer_``)."""
    pattern = re.compile(rf"{layer}(\d+)\.")
    found = {int(m.group(1)) for k in sd for m in [pattern.match(k)] if m}
    return max(found) + 1 if found else 0


def convert_torch_encoder(sd: StateDict, num_layers: int, prefix: str = "net") -> StateDict:
    """torch ``nn.TransformerEncoder`` -> the port's ``encoder`` entries."""
    out: StateDict = {}
    for i in range(num_layers):
        lp, ours = f"{prefix}.layers.{i}", f"encoder.layer_{i}"
        out[f"{ours}.attn.qkv.weight"] = sd[f"{lp}.self_attn.in_proj_weight"]  # [3d, d]
        out[f"{ours}.attn.qkv.bias"] = sd[f"{lp}.self_attn.in_proj_bias"]
        _copy(out, sd, f"{lp}.self_attn.out_proj", f"{ours}.attn.proj")
        for theirs, name in (("norm1", "norm1"), ("norm2", "norm2"), ("linear1", "fc1"),
                             ("linear2", "fc2")):
            _copy(out, sd, f"{lp}.{theirs}", f"{ours}.{name}")
    _copy(out, sd, f"{prefix}.norm", "encoder.final_norm")
    return out


def convert_denoiser(sd: Mapping, stage: str, num_layers: int | None = None) -> StateDict:
    """Reference denoiser state dict -> the port's denoiser state dict
    (``num_layers`` defaults to the layers the state dict holds)."""
    sd = _strip(sd)
    out: StateDict = {}
    for ours, theirs in STREAM_MAPS[stage].items():
        _mlp(out, sd, theirs, ours)
    _mlp(out, sd, "time_embed", "time_embed")
    _mlp(out, sd, "fc_out", "head")
    out.update(convert_torch_encoder(sd, num_layers or num_encoder_layers(sd)))
    if "class_embed.embed.weight" in sd:
        out["class_embed.weight"] = sd["class_embed.embed.weight"]
    return out


def _resnet2d(out, sd, theirs, ours):
    for name in ("norm1", "conv1", "norm2", "conv2"):
        _copy(out, sd, f"{theirs}.{name}", f"{ours}.{name}")
    if f"{theirs}.conv_shortcut.weight" in sd:
        _copy(out, sd, f"{theirs}.conv_shortcut", f"{ours}.conv_shortcut")


def _mid2d(out, sd, theirs, ours):
    """diffusers' mid block: resnet, attention (group_norm, to_q/k/v, to_out.0), resnet."""
    _resnet2d(out, sd, f"{theirs}.resnets.0", f"{ours}.res1")
    a = f"{theirs}.attentions.0"
    for t, o in (("group_norm", "norm"), ("to_q", "q"), ("to_k", "k"), ("to_v", "v"),
                 ("to_out.0", "proj")):
        _copy(out, sd, f"{a}.{t}", f"{ours}.attn.{o}")
    _resnet2d(out, sd, f"{theirs}.resnets.1", f"{ours}.res2")


def convert_surf_vae(sd: Mapping, n_blocks: int = 4, layers_per_block: int = 2) -> StateDict:
    """diffusers ``AutoencoderKL`` state dict -> the port's ``SurfVAE`` state
    dict. A checkpoint of one half (the Fast{En,De}code ones) gives that
    half only: fill it into a full module with ``merge_params``."""
    sd = _strip(sd)
    out: StateDict = {}
    if "encoder.conv_in.weight" in sd:
        _copy(out, sd, "encoder.conv_in", "encoder.conv_in")
        for i in range(n_blocks):
            for j in range(layers_per_block):
                _resnet2d(out, sd, f"encoder.down_blocks.{i}.resnets.{j}",
                          f"encoder.down{i}_res{j}")
            if i < n_blocks - 1:
                _copy(out, sd, f"encoder.down_blocks.{i}.downsamplers.0.conv",
                      f"encoder.down{i}_downsample.conv")
        _mid2d(out, sd, "encoder.mid_block", "encoder.mid")
        _copy(out, sd, "encoder.conv_norm_out", "encoder.norm_out")
        _copy(out, sd, "encoder.conv_out", "encoder.conv_out")
        _copy(out, sd, "quant_conv", "quant_conv")
    if "decoder.conv_in.weight" in sd:
        _copy(out, sd, "decoder.conv_in", "decoder.conv_in")
        _mid2d(out, sd, "decoder.mid_block", "decoder.mid")
        for i in range(n_blocks):
            for j in range(layers_per_block + 1):
                _resnet2d(out, sd, f"decoder.up_blocks.{i}.resnets.{j}", f"decoder.up{i}_res{j}")
            if i < n_blocks - 1:
                _copy(out, sd, f"decoder.up_blocks.{i}.upsamplers.0.conv",
                      f"decoder.up{i}_upsample.conv")
        _copy(out, sd, "decoder.conv_norm_out", "decoder.norm_out")
        _copy(out, sd, "decoder.conv_out", "decoder.conv_out")
        _copy(out, sd, "post_quant_conv", "post_quant_conv")
    return out


def _resconv1d(out, sd, theirs, ours):
    for t, o in (("conv_1", "conv1"), ("group_norm_1", "norm1"), ("conv_2", "conv2"),
                 ("group_norm_2", "norm2")):
        _copy(out, sd, f"{theirs}.{t}", f"{ours}.{o}")
    if f"{theirs}.conv_skip.weight" in sd:
        _copy(out, sd, f"{theirs}.conv_skip", f"{ours}.conv_skip", bias=False)


def _mid1d(out, sd, theirs, ours):
    for i in range(6):
        _resconv1d(out, sd, f"{theirs}.resnets.{i}", f"{ours}.res{i}")
        a = f"{theirs}.attentions.{i}"
        for t, o in (("group_norm", "norm"), ("query", "q"), ("key", "k"), ("value", "v"),
                     ("proj_attn", "proj")):
            _copy(out, sd, f"{a}.{t}", f"{ours}.attn{i}.{o}")


def convert_edge_vae(sd: Mapping, n_blocks: int = 3) -> StateDict:
    """The reference's 1D VAE state dict -> the port's ``EdgeVAE`` state dict."""
    sd = _strip(sd)
    out: StateDict = {}
    if "encoder.conv_in.weight" in sd:
        _copy(out, sd, "encoder.conv_in", "encoder.conv_in")
        for i in range(n_blocks):
            for j in range(3):
                _resconv1d(out, sd, f"encoder.down_blocks.{i}.resnets.{j}",
                           f"encoder.down{i}.res{j}")
        _mid1d(out, sd, "encoder.mid_block", "encoder.mid")
        _copy(out, sd, "encoder.conv_norm_out", "encoder.norm_out")
        _copy(out, sd, "encoder.conv_out", "encoder.conv_out")
        _copy(out, sd, "quant_conv", "quant_conv")
    if "decoder.conv_in.weight" in sd:
        _copy(out, sd, "decoder.conv_in", "decoder.conv_in")
        _mid1d(out, sd, "decoder.mid_block", "decoder.mid")
        for i in range(n_blocks):
            for j in range(3):
                _resconv1d(out, sd, f"decoder.up_blocks.{i}.resnets.{j}", f"decoder.up{i}.res{j}")
        _copy(out, sd, "decoder.conv_norm_out", "decoder.norm_out")
        _copy(out, sd, "decoder.conv_out", "decoder.conv_out")
        _copy(out, sd, "post_quant_conv", "post_quant_conv")
    return out


def merge_params(template: nn.Module | Mapping, partial: Mapping) -> StateDict:
    """A copy of ``template``'s state dict (a module or a state dict) with the
    converted ``partial`` entries filled in (for the Fast half-VAE
    checkpoints that carry one side); a key the template lacks raises."""
    out = dict(template.state_dict() if isinstance(template, nn.Module) else template)
    out = {k: v.detach().clone() for k, v in out.items()}
    unknown = sorted(set(partial) - set(out))
    if unknown:
        raise KeyError(f"keys outside the template: {unknown[:8]}")
    out.update(partial)
    return out


def build_module(kind: str, converted: StateDict) -> nn.Module:
    """The port's module for ``kind`` at the sizes ``converted`` holds."""
    if kind == "surfvae":
        return SurfVAE(block_out_channels=_channels(converted, "encoder.down{}_res0.conv1.weight",
                                                    "decoder.up{}_res0.conv1.weight"))
    if kind == "edgevae":
        return EdgeVAE(block_out_channels=_channels(converted, "encoder.down{}.res0.conv1.weight",
                                                    "decoder.up{}.res0.conv1.weight"))
    width = converted["encoder.layer_0.attn.qkv.weight"].shape[1]
    heads = next((a["denoiser"]["num_heads"] for a in ARCHS.values()
                  if a["denoiser"]["width"] == width), None)
    if heads is None:
        raise ValueError(f"denoiser width {width} matches no architecture of "
                         f"{sorted(ARCHS)}: its head count is unknown")
    classes = converted.get("class_embed.weight")
    kw = {"num_classes": classes.shape[0]} if classes is not None else {}
    return build_denoiser(kind, use_cf=classes is not None, width=width, num_heads=heads,
                          ffn_width=converted["encoder.layer_0.fc1.weight"].shape[0],
                          num_layers=num_encoder_layers(converted, r"encoder\.layer_"), **kw)


def _channels(sd: StateDict, enc: str, dec: str):
    """Block widths from the encoder's first res block of each level (the
    decoder's, reversed, for a decoder-only half)."""
    for fmt, order in ((enc, 1), (dec, -1)):
        widths = []
        while fmt.format(len(widths)) in sd:
            widths.append(int(sd[fmt.format(len(widths))].shape[0]))
        if widths:
            return tuple(widths[::order])
    raise ValueError("no VAE blocks in the state dict")


def convert(kind: str, sd: Mapping) -> StateDict:
    if kind == "surfvae":
        return convert_surf_vae(sd)
    if kind == "edgevae":
        return convert_edge_vae(sd)
    return convert_denoiser(sd, kind)


def main(argv=None) -> str:
    from brepgen_tpu_torch.train.checkpoint import save_params_npz

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--input", required=True, help=".pt state dict of the reference")
    p.add_argument("--kind", required=True, choices=KINDS)
    p.add_argument("--output", required=True, help="npz pack to write (.npz may be left off)")
    args = p.parse_args(argv)

    sd = torch.load(args.input, map_location="cpu", weights_only=True)
    converted = convert(args.kind, sd)
    module = build_module(args.kind, converted)
    module.load_state_dict(converted, strict=True)
    out = args.output[:-len(".npz")] if args.output.endswith(".npz") else args.output
    path = save_params_npz(os.path.dirname(os.path.abspath(out)), module, os.path.basename(out))
    print(f"converted {args.kind}: {args.input} -> {path}")
    return path


if __name__ == "__main__":
    main()
