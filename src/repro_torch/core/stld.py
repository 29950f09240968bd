"""Stochastic Transformer Layer Dropout (STLD), paper §3.2, as
``repro.core.stld``.

``H_{l+1} = (1 - d_l) · Block_l(H_l) + d_l · H_l``, ``d_l ~ Bernoulli(P_l)``.

Two samplers, both on the host from a CPU ``torch.Generator``:

* ``sample_drops`` — the paper's independent Bernoulli gates (``cond``
  mode), with a floor on the number of active layers;
* ``sample_active_indices`` — ``gather`` mode: a fixed count k of active
  layers (``static_active_count``), drawn without replacement with
  inclusion weighted by the keep-probability ``1 - P_l`` (Gumbel top-k).

The layer loop branches on each gate in Python through ``gate``
(``models.transformer.stack_apply``): a dropped layer launches no kernel,
saves no activation for the backward pass and forces no device sync; a
gathered step is a step whose drops are the complement of its indices.
Each call consumes its generator once, as ``repro.core.stld`` consumes its
key once.
"""
from __future__ import annotations

from typing import Callable

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


def sample_active_indices(generator: torch.Generator, rates, k: int):
    """Gather mode: ``k`` distinct layer indices drawn with probability
    proportional to the keep-probability (Gumbel top-k), returned sorted
    (depth order) as a CPU int64 tensor."""
    rates = torch.as_tensor(rates, dtype=torch.float32)
    logits = torch.log(torch.clamp(1.0 - rates, 1e-6, 1.0))
    u = torch.rand(rates.shape, generator=generator, dtype=torch.float32)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    g = logits - torch.log(-torch.log(u))
    idx = torch.argsort(g, descending=True, stable=True)[:k]
    return torch.sort(idx).values


def drops_from_indices(indices, num_layers: int):
    """The (L,) CPU bool gates of a gathered step: every layer outside
    ``indices`` is dropped."""
    drops = torch.ones((num_layers,), dtype=torch.bool)
    drops[torch.as_tensor(indices, dtype=torch.long)] = False
    return drops


def static_active_count(mean_rate: float, num_layers: int, bucket: int = 1, min_active: int = 1) -> int:
    """Static k for gather mode, ``round(L · (1 - mean_rate))`` rounded up
    to a multiple of ``bucket``, within ``[min_active, L]``."""
    k = round(num_layers * (1.0 - mean_rate))
    if bucket > 1:
        k = -(-k // bucket) * bucket
    return int(min(num_layers, max(min_active, k)))


def sample_drops_block(generator: torch.Generator, rates, block_size: int, min_active: int = 1):
    """Structured (LayerDrop-style) gates: contiguous blocks of
    ``block_size`` layers share one Bernoulli gate drawn at the block's
    mean rate; then the per-layer floor of ``min_active``."""
    rates = torch.as_tensor(rates, dtype=torch.float32)
    num_layers = rates.shape[0]
    n_blocks = -(-num_layers // block_size)
    padded = torch.nn.functional.pad(rates, (0, n_blocks * block_size - num_layers))
    counts = torch.full((n_blocks,), float(block_size))
    counts[-1] = num_layers - (n_blocks - 1) * block_size
    block_rates = padded.reshape(n_blocks, block_size).sum(dim=1) / counts
    block_drops = sample_drops(generator, block_rates, min_active=1)
    drops = torch.repeat_interleave(block_drops, block_size)[:num_layers]
    return _force_min_active(drops, rates, min_active)


def gate(block_fn: Callable, drop, h, cache=None):
    """The STLD gate, as the reference's ``lax.cond(drop, identity,
    block_fn)``: ``block_fn(h, cache) -> (h', aux, cache')`` runs only when
    the layer is kept; a dropped layer passes ``h`` and ``cache`` through
    with a 0-d float32 aux of 0.0 and calls nothing.  ``drop`` is a host
    bool or a 0-d CPU tensor (the gates are drawn on the host), so the
    branch reads no device."""
    if bool(drop):
        return h, torch.zeros((), dtype=torch.float32), cache
    return block_fn(h, cache)
