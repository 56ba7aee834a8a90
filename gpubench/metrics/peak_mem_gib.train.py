"""The process's peak of allocated device memory at the end of the training
window (``torch.cuda.max_memory_allocated``), in GiB."""


def read(rec):
    peak = rec["window"].get("peak_bytes")
    return None if not peak else peak / 2 ** 30
