"""The whole window's share of the chip's peak in training: the model FLOPs
of every step (the denoiser's forward and backward at 3 x its forward,
recompute not counted, plus the frozen encodes' forward) over the window's
seconds and the dense peak of the configuration's type."""

from gpubench.counts import window_percent_of_peak


def read(rec):
    return window_percent_of_peak(rec["window"], "model_flops")
