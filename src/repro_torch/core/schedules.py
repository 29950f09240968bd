"""Per-layer dropout-rate distributions (paper §3.3, Fig. 6b), as in
``repro.core.schedules``.

Each distribution maps (mean_rate, L) -> per-layer rates P_l in [0, 1).
``incremental`` (the paper's choice) lets P_l grow with depth.  The rates
are small host-side tensors (float32, on the CPU): the STLD gates are drawn
and branched on by the host.
"""
from __future__ import annotations

from typing import Optional

import torch

_MAX_RATE = 0.95


def _base(distribution: str, num_layers: int, normal_std: float, generator: Optional[torch.Generator]):
    ell = torch.arange(1, num_layers + 1, dtype=torch.float32)
    if distribution == "uniform":
        return torch.ones((num_layers,), dtype=torch.float32)
    if distribution == "incremental":
        return ell / (num_layers + 1)
    if distribution == "decay":
        return 1.0 - ell / (num_layers + 1)
    if distribution == "normal":
        noise = torch.randn((num_layers,), generator=generator, dtype=torch.float32)
        return torch.clamp(1.0 + normal_std * noise, min=0.05)
    raise ValueError(f"unknown dropout distribution {distribution!r}")


def unit_shape(distribution: str, num_layers: int, *, normal_std: float = 0.1,
               generator: Optional[torch.Generator] = None):
    """Unclipped per-layer shape with mean 1.0; multiply by a mean rate and
    clip to get a round's rates.  ``normal`` draws from ``generator`` (a CPU
    ``torch.Generator``; the default generator when None)."""
    base = _base(distribution, num_layers, normal_std, generator)
    return base / torch.mean(base)


def drop_rates(distribution: str, mean_rate: float, num_layers: int, *, normal_std: float = 0.1,
               generator: Optional[torch.Generator] = None):
    """Per-layer dropout rates with the requested mean and shape."""
    if distribution == "normal":
        noise = torch.randn((num_layers,), generator=generator, dtype=torch.float32)
        rates = mean_rate + normal_std * noise
    elif distribution == "uniform":
        rates = torch.full((num_layers,), mean_rate, dtype=torch.float32)
    else:
        base = _base(distribution, num_layers, normal_std, generator)
        rates = base * (mean_rate / torch.mean(base))
    return torch.clamp(rates, 0.0, _MAX_RATE)
