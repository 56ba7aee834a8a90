"""Seconds a batch spends in the two surface stages (surfpos + surfz): the
mean over the window's batches of the cascade's own per-stage times."""


def read(rec):
    times = rec["window"].get("stage_times")
    if not times:
        return None
    return sum(t["surfpos"] + t["surfz"] for t in times) / len(times)
