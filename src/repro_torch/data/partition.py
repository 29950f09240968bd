"""Non-IID Dirichlet partitioning across federated devices (paper §6.1).

A numpy copy of ``repro.data.partition``: the same labels and seed give the
same device shards, index for index.  Partitioning is host-side and seeded
(one ``np.random.default_rng(seed)`` per call), so the split is a pure
function of ``(labels, seed)``, independent of the training stream.
"""
from __future__ import annotations

from typing import List

import numpy as np


def dirichlet_partition(
    labels: np.ndarray,
    num_devices: int,
    alpha: float,
    *,
    min_per_device: int = 8,
    seed: int = 0,
) -> List[np.ndarray]:
    """Split example indices across devices with Dir(alpha) label skew.

    Lower alpha -> stronger label-distribution shift (paper Fig. 15).
    Guarantees every device at least ``min_per_device`` examples by
    re-drawing the allocation when violated (up to 100 attempts).
    """
    rng = np.random.default_rng(seed)
    num_classes = int(labels.max()) + 1
    idx_by_class = [np.where(labels == c)[0] for c in range(num_classes)]
    for _ in range(100):
        device_idx: List[list] = [[] for _ in range(num_devices)]
        for c in range(num_classes):
            idx = idx_by_class[c].copy()
            rng.shuffle(idx)
            props = rng.dirichlet(np.full(num_devices, alpha))
            cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
            for dev, part in enumerate(np.split(idx, cuts)):
                device_idx[dev].extend(part.tolist())  # repro-lint: disable=TXH002 — a numpy array, on the host
        if min(len(d) for d in device_idx) >= min_per_device:
            break
    out = []
    for d in device_idx:
        arr = np.array(sorted(d), dtype=np.int64)
        if len(arr) < min_per_device:  # pathological alpha: top up uniformly
            extra = rng.integers(0, len(labels), size=min_per_device - len(arr))
            arr = np.concatenate([arr, extra])
        out.append(arr)
    return out
