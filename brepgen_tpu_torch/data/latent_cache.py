"""Host-side frozen-VAE latent cache for LDM training (``--cache_latents``).

Port of ``brepgen_tpu/data/latent_cache.py``. The LDM steps encode the
conditioning geometry through the frozen VAEs every step (reference
``trainer.py:519-524,919-929``). The encode is deterministic (posterior
mode, ``network.py:944``), so with rotation augmentation off the same face
or edge grid always maps to the same latent: each sample's grids repeat
every epoch, and padding repeats them within every batch. The cache keys
latents by grid content (blake2b) and encodes only the misses, padded to
``bucket`` rows, so every encode call has one shape.

With augmentation on the rotated grids change every epoch
(``dataset.py:322,499-500``) and the cache is invalid: ``ldm_main`` refuses
``--cache_latents --data_aug``.
"""

from __future__ import annotations

import hashlib
from typing import Callable, Tuple

import numpy as np
import torch


class LatentCache:
    """Content-keyed grids -> latents backed by a frozen encoder.

    ``encode(grids[N, *grid_shape])`` runs on ``device`` and must be
    deterministic; its output is flattened to [N, latent_dim] and kept as f32
    on the host. ``hits`` and ``misses`` count grids looked up."""

    def __init__(self, encode: Callable[[torch.Tensor], torch.Tensor],
                 grid_shape: Tuple[int, ...], latent_dim: int, bucket: int = 1024,
                 device: torch.device | str = "cuda"):
        self.encode = encode
        self.grid_shape = tuple(grid_shape)
        self.latent_dim = latent_dim
        self.bucket = bucket
        self.device = torch.device(device)
        self._store = {}
        self.hits = 0
        self.misses = 0

    def __call__(self, grids: np.ndarray) -> np.ndarray:
        """[N, *grid_shape] -> [N, latent_dim] f32."""
        grids = np.ascontiguousarray(grids, np.float32)
        if grids.shape[1:] != self.grid_shape:
            raise ValueError(f"grids of shape {grids.shape}, expected [N, *{self.grid_shape}]")
        keys = [hashlib.blake2b(row.tobytes(), digest_size=16).digest()
                for row in grids.reshape(len(grids), -1)]
        miss_idx, seen = [], set()
        for i, k in enumerate(keys):
            if k not in self._store and k not in seen:
                seen.add(k)
                miss_idx.append(i)
        if miss_idx:
            self.misses += len(miss_idx)
            miss = grids[miss_idx]
            pad = (-len(miss)) % self.bucket
            if pad:
                miss = np.concatenate([miss, np.zeros((pad,) + self.grid_shape, np.float32)])
            outs = [self.encode(torch.from_numpy(miss[s: s + self.bucket]).to(self.device))
                    .float().cpu().numpy() for s in range(0, len(miss), self.bucket)]
            z = np.concatenate(outs)[: len(miss_idx)].reshape(len(miss_idx), -1)
            if z.shape[1] != self.latent_dim:
                raise ValueError(f"encode gave latents of width {z.shape[1]}, "
                                 f"expected {self.latent_dim}")
            for j, i in enumerate(miss_idx):
                self._store[keys[i]] = z[j]
        self.hits += len(keys) - len(miss_idx)
        return np.stack([self._store[k] for k in keys])

    def __len__(self):
        return len(self._store)
