"""Dataset-shaped wrapper over the synthetic plane scenes: makes the full
training CLI runnable (and smoke-testable) without DTU on disk —
`--trainpath synthetic` in cli/train.py."""
from __future__ import annotations

import numpy as np

from .synthetic import make_synthetic_batch


class SyntheticDataset:
    def __init__(self, n_samples: int = 16, nviews: int = 4, height: int = 64,
                 width: int = 64, ndepths: int = 32, seed: int = 0, **kwargs):
        self.n_samples = n_samples
        self.nviews = nviews
        self.height = height
        self.width = width
        self.ndepths = ndepths
        self.seed = seed
        self._cache = {}

    def __len__(self):
        return self.n_samples

    def __getitem__(self, idx):
        if idx not in self._cache:
            batch = make_synthetic_batch(
                B=1, V=self.nviews, H=self.height, W=self.width,
                ndepth=self.ndepths, seed=self.seed + idx)
            batch.pop("w_aug")
            self._cache[idx] = {
                k: ({kk: vv[0] for kk, vv in v.items()}
                    if isinstance(v, dict) else v[0])
                for k, v in batch.items()
            }
        return self._cache[idx]
