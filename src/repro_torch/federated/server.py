"""Server-side aggregation, as ``repro.federated.server``.

* ``fedavg``              -- plain mean of client PEFT trees (FedLoRA and
                             the DropPEFT-b3 ablation).
* ``ptls_aggregate``      -- heterogeneous layer aggregation (paper Fig. 8):
                             per layer, average only the devices that
                             shared it.
* ``cohort_shared_masks`` -- per-device share masks from an (N, L)
                             importance matrix.
* ``select_layers``       -- per-layer global/local mix for PTLS client
                             init on stacked trees.
* ``hetlora_aggregate``   -- FedHetLoRA: rank-heterogeneous LoRA trees
                             zero-padded to the largest rank, then averaged
                             by rank share; ``truncate_lora_rank`` cuts the
                             global tree down to a device's rank.

Plain tensor code on the trees' device.  Every aggregator takes both layer
layouts (``models.stacking``): the stacked layout is one masked ``(N, L,
...)`` reduction per leaf, the list layout a loop over layers.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import ptls
from repro_torch.models import stacking


def cohort_shared_masks(importances, k: int) -> torch.Tensor:
    """(N, L) importances -> (N, L) bool share masks (Eq. 6 / Fig. 8): row
    n is ``ptls.shared_layer_mask(importances[n], k)``, for all rows in one
    stable sort."""
    importances = torch.as_tensor(importances)
    order = torch.argsort(importances, dim=-1, stable=True)[:, : min(k, importances.shape[-1])]
    return torch.zeros(importances.shape, dtype=torch.bool, device=importances.device).scatter_(1, order, True)


def screen_finite(tree, fallback=None):
    """Replace the non-finite elements of an aggregated tree, element by
    element, from ``fallback`` (a tree of the same structure) or by zero.
    On an all-finite tree every element is the aggregate's own, bit for
    bit."""
    if fallback is None:
        return stacking.tree_map(lambda x: torch.where(torch.isfinite(x), x, torch.zeros_like(x)), tree)
    return stacking.tree_map(lambda x, f: torch.where(torch.isfinite(x), x, f), tree, fallback)


def fedavg(client_trees: Sequence):
    """Mean over clients of identical trees (either layout): Python's
    ``sum(xs) / len(xs)``, added left to right from 0."""
    return screen_finite(stacking.tree_map(lambda *xs: sum(xs) / len(xs), *client_trees))


def staleness_weights(staleness, alpha: float) -> np.ndarray:
    """FedBuff-style staleness discount: w_i ∝ 1/(1+s_i)^alpha, normalized
    (float64, on the host).  ``alpha=0`` is uniform."""
    s = np.asarray(staleness, dtype=np.float64)
    w = 1.0 / np.power(1.0 + s, float(alpha))
    return w / w.sum()


def weighted_fedavg(client_trees: Sequence, weights):
    """Weighted mean over clients of identical trees; ``weights`` (N,) sum
    to 1 and are taken in float32, as the reference takes them."""
    w = torch.as_tensor(np.asarray(weights, dtype=np.float32).ravel())

    def mean(*xs):
        wd = w.to(xs[0].device)
        return sum(wd[i] * x for i, x in enumerate(xs))

    return screen_finite(stacking.tree_map(mean, *client_trees))


def select_layers(mask, global_tree, own_tree):
    """Stacked-tree PTLS client init: layer ``l`` from ``global_tree``
    where ``mask[l]`` (shared: refreshed from the server), else from
    ``own_tree`` (personalized: kept local).  Exact copies."""
    return stacking.select_layers(mask, global_tree, own_tree)


def _stack_clients(trees):
    return stacking.tree_map(lambda *xs: torch.stack(xs), *trees)


def ptls_aggregate(client_peft, masks, global_peft, weights=None):
    """Heterogeneous PTLS aggregation (paper Fig. 8).

    ``client_peft``: per-client PEFT trees (a sequence), or one stacked
    cohort tree whose leaves carry a leading ``(N, ...)`` device axis.
    ``masks``: (N, L) bool.  ``global_peft`` sets the output layout.
    ``weights`` (optional, (N,)) switches to the weighted masked mean.
    Non-finite elements of the result fall back to ``global_peft``'s.
    """
    device = next((x.device for x in stacking.tree_leaves(global_peft)), None)  # None: a leafless tree
    masks = torch.as_tensor(masks, device=device).bool()
    if isinstance(global_peft, (list, tuple)):
        stacked = [_stack_clients([c[l] for c in client_peft]) for l in range(len(global_peft))]
    elif isinstance(client_peft, (list, tuple)):
        stacked = _stack_clients(client_peft)
    else:
        stacked = client_peft
    return screen_finite(ptls.masked_layer_mean(stacked, masks, global_peft, weights), fallback=global_peft)


def _pad_lora(lora: dict, rank: int) -> dict:
    """Zero-pad LoRA factors to ``rank`` along the rank axis: per-layer
    ``(d, r)``/``(r, d)`` and stacked ``(L, d, r)``/``(L, r, d)`` leaves
    alike."""
    a, b = lora["a"], lora["b"]
    return {"a": F.pad(a, (0, rank - a.shape[-1])), "b": F.pad(b, (0, 0, 0, rank - b.shape[-2]))}


def _pad_layer(layer: dict, rank: int) -> dict:
    return {grp: {t: _pad_lora(lora, rank) for t, lora in sub.items()} for grp, sub in layer.items()}


def _weighted_tree_mean(weights, *trees):
    """``sum(w_i * tree_i)`` over identically shaped trees, added left to
    right from 0, then screened for non-finite elements."""
    return screen_finite(stacking.tree_map(lambda *xs: sum(w * x for w, x in zip(weights, xs)), *trees))


def hetlora_aggregate(client_peft: Sequence, ranks: Sequence[int], max_rank: int, extra_weights=None):
    """FedHetLoRA: zero-pad each client's LoRA factors to ``max_rank`` and
    weight each client by its rank share (sparsity-weighted aggregation).

    ``extra_weights`` (optional, (N,)) multiplies the rank shares (the
    scheduler's staleness weights); the product is renormalised.  The
    weights are computed in float64 on the host and applied as float32, as
    the reference applies them.  Per-client trees in either layout."""
    weights = np.asarray(ranks, dtype=np.float64)
    weights = weights / weights.sum()
    if extra_weights is not None:
        weights = weights * np.asarray(extra_weights, dtype=np.float64)
        weights = weights / weights.sum()
    weights = [float(np.float32(w)) for w in weights]
    if not isinstance(client_peft[0], (list, tuple)):
        return _weighted_tree_mean(weights, *[_pad_layer(c, max_rank) for c in client_peft])
    return [_weighted_tree_mean(weights, *[_pad_layer(c[l], max_rank) for c in client_peft])
            for l in range(len(client_peft[0]))]


def truncate_lora_rank(peft_layers, rank: int):
    """A max-rank global LoRA tree cut down to a client's rank (the first
    ``rank`` columns of ``a`` and rows of ``b``), in either layout; the
    leaves are contiguous copies."""

    def trunc(lora):
        return {"a": lora["a"][..., :rank].contiguous(), "b": lora["b"][..., :rank, :].contiguous()}

    def trunc_layer(layer):
        return {grp: {t: trunc(lora) for t, lora in sub.items()} for grp, sub in layer.items()}

    if isinstance(peft_layers, (list, tuple)):
        return [trunc_layer(layer) for layer in peft_layers]
    return trunc_layer(peft_layers)
