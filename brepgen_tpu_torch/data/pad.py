"""Set padding helpers (reference ``utils.py:100-118``).

The port's own numpy copy of ``brepgen_tpu/data/pad.py``.

``pad_repeat`` tiles elements so duplicates are semantically harmless (used
for the surfPos stage where tokens are an unmasked set); ``pad_zero`` pads
with zeros and returns the key-padding mask (True = padded).
"""

from __future__ import annotations

import math

import numpy as np


def pad_repeat(x: np.ndarray, max_len: int) -> np.ndarray:
    repeat_times = math.floor(max_len / len(x))
    sep = max_len - repeat_times * len(x)
    sep1 = np.repeat(x[:sep], repeat_times + 1, axis=0)
    sep2 = np.repeat(x[sep:], repeat_times, axis=0)
    return np.concatenate([sep1, sep2], 0)


def pad_zero(x: np.ndarray, max_len: int, return_mask: bool = False):
    n = len(x)
    padding = np.zeros((max_len - n, *x.shape[1:]), dtype=x.dtype)
    x_padded = np.concatenate([x, padding], axis=0)
    if return_mask:
        mask = np.zeros(max_len, dtype=bool)
        mask[n:] = True
        return x_padded, mask
    return x_padded
