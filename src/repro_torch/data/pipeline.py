"""Per-device data pipeline: shuffled batching and the train/val split.

A numpy copy of ``repro.data.pipeline``: the same shard and seed give the
same split and the same batches, in the same order.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np


class DeviceDataset:
    """One federated device's local shard with train/val split."""

    def __init__(self, task, indices: np.ndarray, *, val_fraction: float = 0.2, seed: int = 0):
        self.task = task
        rng = np.random.default_rng(seed)
        idx = indices.copy()
        rng.shuffle(idx)
        n_val = max(1, int(len(idx) * val_fraction))
        self.val_idx = idx[:n_val]
        self.train_idx = idx[n_val:] if len(idx) > n_val else idx
        self._rng = rng

    def train_batches(self, batch_size: int, num_batches: int) -> Iterator[dict]:
        for _ in range(num_batches):
            # a fixed batch size (drawn with replacement on small shards)
            take = self._rng.choice(
                self.train_idx, size=batch_size, replace=len(self.train_idx) < batch_size
            )
            yield self.task.lm_batch(take)

    def val_batch(self, max_examples: int = 64) -> dict:
        return self.task.lm_batch(self.val_idx[:max_examples])

    def __len__(self):
        return len(self.train_idx)
