"""Host microseconds of one scheduler update between two denoiser calls: the
mean duration of the program's spans ``brepgen.cascade.update``
(``brepgen_tpu_torch.utils.profiling``) in the traced batch."""


def read(rec):
    if rec["trace"] is None:
        return None
    try:
        from brepgen_tpu_torch.utils.profiling import summary
    except ImportError:  # a program without the span recorder
        return None
    update = summary().get("brepgen.cascade.update")
    if not update or not update["count"]:
        return None
    return update["host_s"] / update["count"] * 1e6
