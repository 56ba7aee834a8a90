"""The edge stages' attention forward against its roofline, in the traced
batch: the least time of its work (4 B S^2 W operations a layer and call,
qkv read and output written once; ``counts.attention_fwd``), the larger of
operations over the peak and bytes over the bandwidth, over the device time
of the kernels that implement it (K1/K2 and K3, named below). The surface
stages' plain attention over 60 tokens is not counted."""

from gpubench.trace import roofline_percent

KERNELS = ("packed_attention_kernel", "packed_attention_wgmma_kernel",
           "set_attention_kernel", "set_attention_wgmma_kernel")


def read(rec):
    return roofline_percent(rec["trace"], "attn_fwd_ops", "attn_fwd_bytes", KERNELS)
