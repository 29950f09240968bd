"""Stochastic Transformer Layer Dropout (STLD), paper §3.2, in ``cond`` mode.

``H_{l+1} = (1 - d_l) · Block_l(H_l) + d_l · H_l``, ``d_l ~ Bernoulli(P_l)``.

The gates are drawn on the host from a CPU ``torch.Generator`` and the
layer loop branches on them in Python (``models.transformer.stack_apply``):
a dropped layer launches no kernel, saves no activation for the backward
pass and forces no device sync.  Each call consumes its generator once, as
``repro.core.stld`` consumes its key once.
"""
from __future__ import annotations

import torch


def expected_active_layers(rates) -> torch.Tensor:
    """E[L-tilde] = sum_l (1 - P_l)   (paper Eq. 4)."""
    return torch.sum(1.0 - rates)


def _force_min_active(drops, rates, min_active: int):
    """Enforce the active-layer floor: if fewer than ``min_active`` layers
    survive, force-activate the dropped layers with the smallest rates."""
    active = int(torch.sum(~drops))
    need = max(min_active - active, 0)
    order = torch.argsort(torch.where(drops, rates, torch.inf), stable=True)
    rank_of = torch.argsort(order, stable=True)
    force = drops & (rank_of < need)
    return drops & ~force


def sample_drops(generator: torch.Generator, rates, min_active: int = 1):
    """Independent Bernoulli gates d_l (True = dropped) as a CPU bool
    tensor, with a floor of ``min_active`` active layers."""
    u = torch.rand(rates.shape, generator=generator, dtype=torch.float32)
    return _force_min_active(u < rates, rates, min_active)
