"""Seconds a batch spends in the two edge stages (edgepos + edgez): the mean
over the window's batches of the cascade's own per-stage times
(``Cascade.__call__``'s ``stage_times``, host clock, synchronised per
stage)."""


def read(rec):
    times = rec["window"].get("stage_times")
    if not times:
        return None
    return sum(t["edgepos"] + t["edgez"] for t in times) / len(times)
