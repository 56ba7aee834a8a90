"""The attention backward against its roofline in the traced training
steps: the least time of one backward a layer and step
(``counts.attention_bwd``) over the device time of the kernels that run it
(K5, named below)."""

from gpubench.trace import roofline_percent

KERNELS = ("dq_kernel", "dkv_kernel", "dq_wgmma_kernel", "dkv_wgmma_kernel")


def read(rec):
    return roofline_percent(rec["trace"], "attn_bwd_ops", "attn_bwd_bytes", KERNELS)
