"""Port: ``tools/convert_torch.py`` against the JAX package's converter.

For each ``--kind`` a state dict under the reference's key names (torch
``nn.TransformerEncoder`` denoisers, diffusers ``AutoencoderKL``, the
reference's 1D VAE), with a distinct random value in every tensor, goes
through JAX's ``convert_*`` -> ``weights.load_flax_params`` and through the
port's direct conversion; the two modules' state dicts are equal (atol 0).
``merge_params`` fills a half-VAE into a template, and the CLI turns a
``.pt`` into a pack that loads strictly.
"""

import re

import numpy as np
import pytest
import torch

from brepgen_tpu.tools import convert_torch as jconv
from brepgen_tpu_torch import nn as tnn
from brepgen_tpu_torch.tools import convert_torch as conv
from brepgen_tpu_torch.train.checkpoint import load_params
from brepgen_tpu_torch.weights import load_flax_params

SMALL = dict(width=32, num_heads=2, ffn_width=64, num_layers=2)
# the reference's stream embedders, per stage (network.py:1066-1393)
THEIRS = {
    "surfpos": {"surfpos": "p_embed"},
    "surfz": {"surfz": "z_embed", "surfpos": "p_embed"},
    "edgepos": {"edgepos": "edgep_embed", "surfpos": "surfp_embed", "surfz": "surfz_embed"},
    "edgez": {"edgez": "edgez_embed", "vertpos": "vertp_fc", "edgepos": "edgep_embed",
              "surfpos": "surfp_embed", "surfz": "surfz_embed"},
}
# the reference's names of the port's parameters, written from the
# reference's modules (ordered regex renames, per kind)
DENOISER = [
    (r"^encoder\.layer_(\d+)\.attn\.qkv\.weight$", r"net.layers.\1.self_attn.in_proj_weight"),
    (r"^encoder\.layer_(\d+)\.attn\.qkv\.bias$", r"net.layers.\1.self_attn.in_proj_bias"),
    (r"^encoder\.layer_(\d+)\.attn\.proj\.", r"net.layers.\1.self_attn.out_proj."),
    (r"^encoder\.layer_(\d+)\.fc1\.", r"net.layers.\1.linear1."),
    (r"^encoder\.layer_(\d+)\.fc2\.", r"net.layers.\1.linear2."),
    (r"^encoder\.layer_(\d+)\.norm(\d)\.", r"net.layers.\1.norm\2."),
    (r"^encoder\.final_norm\.", "net.norm."),
    (r"^class_embed\.weight$", "class_embed.embed.weight"),
    (r"^head\.", "fc_out."),
    # embedders and head: Sequential(Linear, LayerNorm, SiLU, Linear)
    (r"^(?!net\.)([^.]+)\.fc1\.", r"\1.0."), (r"^(?!net\.)([^.]+)\.norm\.", r"\1.1."),
    (r"^(?!net\.)([^.]+)\.fc2\.", r"\1.3."),
]
SURF_VAE = [
    (r"^(encoder|decoder)\.mid\.res1\.", r"\1.mid_block.resnets.0."),
    (r"^(encoder|decoder)\.mid\.res2\.", r"\1.mid_block.resnets.1."),
    (r"^(encoder|decoder)\.mid\.attn\.norm\.", r"\1.mid_block.attentions.0.group_norm."),
    (r"^(encoder|decoder)\.mid\.attn\.(q|k|v)\.", r"\1.mid_block.attentions.0.to_\2."),
    (r"^(encoder|decoder)\.mid\.attn\.proj\.", r"\1.mid_block.attentions.0.to_out.0."),
    (r"^encoder\.down(\d)_res(\d)\.", r"encoder.down_blocks.\1.resnets.\2."),
    (r"^encoder\.down(\d)_downsample\.", r"encoder.down_blocks.\1.downsamplers.0."),
    (r"^decoder\.up(\d)_res(\d)\.", r"decoder.up_blocks.\1.resnets.\2."),
    (r"^decoder\.up(\d)_upsample\.", r"decoder.up_blocks.\1.upsamplers.0."),
    (r"\.norm_out\.", ".conv_norm_out."),
]
EDGE_VAE = [
    (r"\.mid\.attn(\d)\.norm\.", r".mid_block.attentions.\1.group_norm."),
    (r"\.mid\.attn(\d)\.q\.", r".mid_block.attentions.\1.query."),
    (r"\.mid\.attn(\d)\.k\.", r".mid_block.attentions.\1.key."),
    (r"\.mid\.attn(\d)\.v\.", r".mid_block.attentions.\1.value."),
    (r"\.mid\.attn(\d)\.proj\.", r".mid_block.attentions.\1.proj_attn."),
    (r"\.mid\.res(\d)\.", r".mid_block.resnets.\1."),
    (r"^encoder\.down(\d)\.res(\d)\.", r"encoder.down_blocks.\1.resnets.\2."),
    (r"^decoder\.up(\d)\.res(\d)\.", r"decoder.up_blocks.\1.resnets.\2."),
    (r"\.conv(\d)\.", r".conv_\1."), (r"\.norm(\d)\.", r".group_norm_\1."),
    (r"\.norm_out\.", ".conv_norm_out."),
]


def _port_module(kind):
    if kind == "surfvae":
        return tnn.SurfVAE((8, 16, 16, 32))
    if kind == "edgevae":
        return tnn.EdgeVAE((8, 16, 32))
    return getattr(tnn, f"make_{kind}_net")(use_cf=kind == "edgez", num_classes=4, **SMALL)


def _reference_state_dict(kind, seed=0, prefix=""):
    """A state dict under the reference's names, each tensor distinct."""
    module = _port_module(kind)
    if kind == "surfvae":
        rules = SURF_VAE
    elif kind == "edgevae":
        rules = EDGE_VAE
    else:
        rules = [(rf"^{k}_embed\.", f"{v}.") for k, v in THEIRS[kind].items()] + DENOISER
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for key, value in module.state_dict().items():
        name = key
        for pattern, repl in rules:
            name = re.sub(pattern, repl, name)
        sd[prefix + name] = torch.randn(value.shape, generator=gen)
    return sd


def _jax_route(kind, sd):
    np_sd = {k: v.numpy() for k, v in sd.items()}
    if kind == "surfvae":
        tree = jconv.convert_surf_vae(np_sd)
    elif kind == "edgevae":
        tree = jconv.convert_edge_vae(np_sd)
    else:
        tree = jconv.convert_denoiser(np_sd, kind, num_layers=SMALL["num_layers"])
    return load_flax_params(_port_module(kind), tree)


@pytest.mark.parametrize("kind", conv.KINDS)
def test_conversion_equals_jax_route(kind):
    sd = _reference_state_dict(kind, prefix="module." if kind == "edgez" else "")
    want = _jax_route(kind, sd).state_dict()
    got = conv.convert(kind, sd)
    module = conv.build_module(kind, got)
    module.load_state_dict(got, strict=True)
    assert sorted(got) == sorted(want)
    for k, v in module.state_dict().items():
        assert torch.equal(v, want[k]), k
    if kind == "edgez":
        assert module.class_embed.weight.shape == (4, SMALL["width"])


@pytest.mark.parametrize("kind", ["surfvae", "edgevae"])
def test_merge_params_fills_one_half(kind):
    sd = _reference_state_dict(kind, seed=1)
    decoder_half = {k: v for k, v in sd.items()
                    if k.startswith(("decoder.", "post_quant_conv."))}
    partial = conv.convert(kind, decoder_half)
    assert partial and all(k.startswith(("decoder.", "post_quant_conv.")) for k in partial)
    template = _port_module(kind)
    merged = conv.merge_params(template, partial)
    template_sd = template.state_dict()
    assert sorted(merged) == sorted(template_sd)
    for k, v in merged.items():
        assert torch.equal(v, partial[k] if k in partial else template_sd[k]), k
    with pytest.raises(KeyError, match="outside the template"):
        conv.merge_params(template, {"decoder.nothing.weight": torch.zeros(1)})


@pytest.mark.parametrize("kind", ["edgez", "surfvae"])
def test_cli_writes_a_pack_that_loads_strictly(tmp_path, kind, capsys):
    sd = _reference_state_dict(kind, seed=2)
    torch.save(sd, tmp_path / "ref.pt")
    path = conv.main(["--input", str(tmp_path / "ref.pt"), "--kind", kind,
                      "--output", str(tmp_path / "out" / kind)])
    assert path == str(tmp_path / "out" / f"{kind}.npz")
    assert "converted" in capsys.readouterr().out
    want = _jax_route(kind, sd).state_dict()
    module = load_params(path, _port_module(kind))
    for k, v in module.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k].numpy(), err_msg=k)
