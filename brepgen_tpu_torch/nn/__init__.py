from brepgen_tpu_torch.nn.denoiser import (
    DenoiserTransformer,
    make_edgepos_net,
    make_edgez_net,
    make_surfpos_net,
    make_surfz_net,
)
from brepgen_tpu_torch.nn.vae1d import EdgeVAE
from brepgen_tpu_torch.nn.vae2d import SurfVAE

__all__ = [
    "DenoiserTransformer",
    "EdgeVAE",
    "SurfVAE",
    "make_edgepos_net",
    "make_edgez_net",
    "make_surfpos_net",
    "make_surfz_net",
]
