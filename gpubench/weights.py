"""Weights made from the seed, on the device, in float32, in a few calls:
one uniform draw for every dense and convolution tensor, scaled to
+-1/sqrt(fan_in) (torch's default bound; a bias takes its weight's fan-in),
norms at scale 1 and shift 0. The same tensors are loaded into the program's
modules and handed to the reference."""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch


def _is_norm(name: str) -> bool:
    return "norm" in name.rsplit(".", 2)[-2]


def make(shapes: Mapping[str, Mapping[str, Tuple[int, ...]]], generator: torch.Generator,
         device) -> Dict[str, Dict[str, torch.Tensor]]:
    """{module: {parameter: shape}} -> {module: {parameter: f32 tensor}}."""
    uniform, sizes, bounds = [], [], []
    out: Dict[str, Dict[str, torch.Tensor]] = {m: {} for m in shapes}
    for module, params in shapes.items():
        for name, shape in params.items():
            if _is_norm(name):
                fill = 1.0 if name.endswith("weight") else 0.0
                out[module][name] = torch.full(shape, fill, dtype=torch.float32, device=device)
                continue
            weight = params[name.rsplit(".", 1)[0] + ".weight"]
            fan_in = 1
            for d in weight[1:]:
                fan_in *= d
            n = 1
            for d in shape:
                n *= d
            uniform.append((module, name, shape))
            sizes.append(n)
            bounds.append(fan_in ** -0.5)
    if uniform:
        flat = torch.rand(sum(sizes), generator=generator, device=device)
        scale = torch.repeat_interleave(torch.tensor(bounds, device=device),
                                        torch.tensor(sizes, device=device))
        flat = (flat * 2.0 - 1.0) * scale
        for (module, name, shape), part in zip(uniform, flat.split(sizes)):
            out[module][name] = part.view(shape)
    return out


def shapes_of(module: torch.nn.Module) -> Dict[str, Tuple[int, ...]]:
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}
