"""The attention forward against its roofline in the traced training steps:
the least time of one forward a layer and step (``counts.attention_fwd``)
over the device time of the kernels that run it, the recompute's launches
included (K1, named below)."""

from gpubench.trace import roofline_percent

KERNELS = ("packed_attention_kernel", "packed_attention_wgmma_kernel",
           "set_attention_kernel", "set_attention_wgmma_kernel")


def read(rec):
    return roofline_percent(rec["trace"], "attn_fwd_ops", "attn_fwd_bytes", KERNELS)
