"""Hand-written CUDA kernels of the port, their plain PyTorch versions and
their launch counts.

Each wrapper adds one to ``LAUNCH_COUNTS[<kernel>]`` where it launches its
kernel, and nowhere else, so a run can show that it went through the kernel.
"""

LAUNCH_COUNTS = {"packed_attention": 0, "packed_flash_attention": 0, "set_attention": 0,
                 "chamfer": 0}


def reset_launch_counts() -> None:
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0
