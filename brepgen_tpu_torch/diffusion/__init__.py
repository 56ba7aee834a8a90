from brepgen_tpu_torch.diffusion.ddim import ddim_loop, make_ddim_plan, slice_plan
from brepgen_tpu_torch.diffusion.ddpm import (
    DDPMTables,
    add_noise,
    ddpm_loop,
    make_ddpm_plan,
    make_ddpm_tables,
)
from brepgen_tpu_torch.diffusion.pndm import (
    make_pndm_plan,
    pndm_init_carry,
    pndm_loop,
    pndm_loop_carry,
)

__all__ = [
    "DDPMTables", "add_noise", "make_ddpm_tables", "ddim_loop", "ddpm_loop", "make_ddim_plan", "make_ddpm_plan", "make_pndm_plan",
    "pndm_init_carry", "pndm_loop", "pndm_loop_carry", "slice_plan",
]
