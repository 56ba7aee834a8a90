"""The whole window's share of the chip's peak in scoring: the operations of
every Chamfer matrix the window's repeats took (``counts.chamfer``) over the
window's seconds and the f32 peak (67 TFLOP/s); the host's share of a
repeat (copies, MMD, COV, JSD) counts as time."""

from gpubench.counts import window_percent_of_peak


def read(rec):
    return window_percent_of_peak(rec["window"], "chamfer_ops")
