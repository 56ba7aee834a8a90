"""Host milliseconds a protocol repeat spends in JSD (the occupancy counts of
both sets on the host): the mean duration of the program's spans
``brepgen.eval.jsd`` (``brepgen_tpu_torch.utils.profiling``) in the traced
repeat."""


def read(rec):
    if rec["trace"] is None:
        return None
    try:
        from brepgen_tpu_torch.utils.profiling import summary
    except ImportError:  # a program without the span recorder
        return None
    jsd = summary().get("brepgen.eval.jsd")
    if not jsd or not jsd["count"]:
        return None
    return jsd["host_s"] / jsd["count"] * 1e3
