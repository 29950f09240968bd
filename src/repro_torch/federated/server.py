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

Plain tensor code on the trees' device.  Every aggregator takes both layer
layouts (``models.stacking``): the stacked layout is one masked ``(N, L,
...)`` reduction per leaf, the list layout a loop over layers.  The
rank-heterogeneous FedHetLoRA aggregation is not ported.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

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
    device = stacking.tree_leaves(global_peft)[0].device
    masks = torch.as_tensor(masks, device=device).bool()
    if isinstance(global_peft, (list, tuple)):
        stacked = [_stack_clients([c[l] for c in client_peft]) for l in range(len(global_peft))]
    elif isinstance(client_peft, (list, tuple)):
        stacked = _stack_clients(client_peft)
    else:
        stacked = client_peft
    return screen_finite(ptls.masked_layer_mean(stacked, masks, global_peft, weights), fallback=global_peft)
