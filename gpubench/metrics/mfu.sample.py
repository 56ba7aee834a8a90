"""The whole window's share of the chip's peak: the model FLOPs of every
denoiser call the window's batches made (``counts.denoiser_flops_per_eval``
at each call's batch and length) over the window's seconds and the dense
peak of the configuration's type (989 TFLOP/s in bf16)."""

from gpubench.counts import window_percent_of_peak


def read(rec):
    return window_percent_of_peak(rec["window"], "model_flops")
