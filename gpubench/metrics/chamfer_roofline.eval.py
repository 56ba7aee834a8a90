"""The Chamfer matrix against its roofline in the traced repeat: the least
time of its work (each point-pair distance once, 8 operations, at the f32
peak of 67 TFLOP/s; ``counts.chamfer``) over the device time of the kernel
that runs it (K4, named below)."""

from gpubench.trace import roofline_percent

KERNELS = ("chamfer_kernel",)


def read(rec):
    return roofline_percent(rec["trace"], "chamfer_ops", "chamfer_bytes", KERNELS)
