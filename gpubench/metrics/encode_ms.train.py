"""Device milliseconds a training step spends in the frozen VAE encodes: the
device time launched under the benchmark's spans around the two encoder
callables it hands to ``make_edgez_step``, over the traced steps."""


def read(rec):
    t = rec["trace"]
    if t is None or "steps" not in t.get("work", {}):
        return None
    spans = t["span_device_s"]
    seconds = spans.get("train.encode_surf", 0.0) + spans.get("train.encode_edge", 0.0)
    if seconds <= 0:
        return None
    return seconds / t["work"]["steps"] * 1e3
