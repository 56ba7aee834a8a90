"""Device milliseconds a training step spends in the frozen VAE encodes, from
inside the program: the device-stream seconds between the CUDA events of its
spans ``brepgen.train.encode`` (``brepgen_tpu_torch.utils.profiling``) over
the count of its spans ``brepgen.train.step`` in the traced steps."""


def read(rec):
    if rec["trace"] is None:
        return None
    try:
        from brepgen_tpu_torch.utils.profiling import summary
    except ImportError:  # a program without the span recorder
        return None
    spans = summary()
    step, encode = spans.get("brepgen.train.step"), spans.get("brepgen.train.encode")
    if not step or not encode or encode["device_s"] <= 0:
        return None
    return encode["device_s"] / step["count"] * 1e3
