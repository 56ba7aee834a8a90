"""Device milliseconds a training step spends in the denoiser's forward and
backward (the recompute included): the device-stream seconds between the
CUDA events of the program's spans ``brepgen.train.forward`` (draws,
augmentation, noising, the denoiser and the losses) and
``brepgen.train.backward`` (``brepgen_tpu_torch.utils.profiling``) over the
count of its spans ``brepgen.train.step`` in the traced steps."""


def read(rec):
    if rec["trace"] is None:
        return None
    try:
        from brepgen_tpu_torch.utils.profiling import summary
    except ImportError:  # a program without the span recorder
        return None
    spans = summary()
    step = spans.get("brepgen.train.step")
    parts = [spans.get(f"brepgen.train.{k}") for k in ("forward", "backward")]
    if not step or not all(parts) or any(p["device_s"] <= 0 for p in parts):
        return None
    return sum(p["device_s"] for p in parts) / step["count"] * 1e3
