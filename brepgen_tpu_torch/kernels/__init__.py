"""Hand-written CUDA kernels of the port, their plain PyTorch versions and
their launch counts.

Each wrapper adds one to ``LAUNCH_COUNTS[<kernel>]`` where it launches its
kernel, and nowhere else, so a run can show that it went through the kernel.
"""

LAUNCH_COUNTS = {"packed_attention": 0, "packed_flash_attention": 0, "set_attention": 0,
                 "chamfer": 0, "packed_attention_backward": 0, "vae_attention": 0,
                 "add_layer_norm": 0}

# The device functions each wrapper launches (names as the CUDA sources give
# them) and how many launches one call makes; a captured graph's kernel
# nodes are counted by these
_K1 = ("packed_attention_kernel", "packed_attention_wgmma_kernel")
KERNEL_FUNCTIONS = {"packed_attention": (_K1, 1), "packed_flash_attention": (_K1, 1),
                    "set_attention": (("set_attention_kernel", "set_attention_wgmma_kernel"), 1),
                    "chamfer": (("chamfer_kernel",), 1),
                    "packed_attention_backward": (
                        ("dq_kernel", "dkv_kernel", "dq_wgmma_kernel", "dkv_wgmma_kernel"), 2),
                    "vae_attention": (("vae_attention_kernel",), 1),
                    "add_layer_norm": (("add_layer_norm_kernel",), 1)}


def reset_launch_counts() -> None:
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0
