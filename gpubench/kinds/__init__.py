"""The cell drivers, one per kind of traffic mix (the mix's ``kind``).

Each module holds ``Run(config, mix, seed, device)`` with ``setup()``,
``window(seconds)`` -> {"metrics", "attempted", "failed", "records"},
``traced()`` -> the trace summary of one steady unit of work,
``release()`` (frees the program's state before the reference runs) and
``readings(control=False)`` -> {name: reading}, the numbers the check may
compare; ``gpubench/limits/<cell>.json`` names those it does.
"""
