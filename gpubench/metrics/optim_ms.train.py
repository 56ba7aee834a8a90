"""Device milliseconds a training step spends in the optimizer (the global
norm clip and AdamW): the device-stream seconds between the CUDA events of
the program's spans ``brepgen.train.optimizer``
(``brepgen_tpu_torch.utils.profiling``) over the count of its spans
``brepgen.train.step`` in the traced steps."""


def read(rec):
    if rec["trace"] is None:
        return None
    try:
        from brepgen_tpu_torch.utils.profiling import summary
    except ImportError:  # a program without the span recorder
        return None
    spans = summary()
    step, optim = spans.get("brepgen.train.step"), spans.get("brepgen.train.optimizer")
    if not step or not optim or optim["device_s"] <= 0:
        return None
    return optim["device_s"] / step["count"] * 1e3
