"""Personalized Transformer Layer Sharing (PTLS), paper §4.

Per-layer importance (Eq. 6) is the STLD-masked average gradient norm

    I_l = (1 / sum_b (1 - d_l^b)) * sum_b g_l^b (1 - d_l^b)

High-I_l layers are *personalized* (kept local); each device uploads the k
layers with the LOWEST importance.  The server averages only overlapping
layers (Fig. 8): for layer l, new_global_l = mean over devices sharing l;
layers shared by no device keep the previous global value.  PEFT trees are
in either layout of ``models.stacking``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import stacking


def layer_grad_norms(peft_grads, devices: Optional[int] = None, num_layers: int = 0) -> torch.Tensor:
    """L2 norm of each layer's PEFT gradient, shape ``(L,)`` float32.

    Stacked layout: per-leaf trailing-axis sums of squares, added over the
    leaves; a per-layer list of one structure (``layout="list"``) is
    stacked first.  Per-layer list of a heterogeneous hybrid stack, as the
    reference's list branch: each layer's per-leaf sums of squares added
    in leaf order (0 for a layer without leaves), stacked.

    ``devices`` N: a cohort's per-layer list with (N, ...) leaves gives
    ``(N, L)``, each device's norms summed as the stacked layout sums them.
    ``num_layers`` is read only for a leafless stacked tree (PEFT method
    ``none``), whose norms are zeros, as the reference's.
    """
    if devices is not None:
        device = next((x.device for x in stacking.tree_leaves(peft_grads)), None)
        norms = []
        for layer in peft_grads:
            leaves = stacking.tree_leaves(layer)
            sq = sum(torch.sum(torch.square(x.float()), dim=tuple(range(1, x.ndim))) for x in leaves)
            norms.append(torch.sqrt(sq) if leaves else torch.zeros((devices,), dtype=torch.float32, device=device))
        return torch.stack(norms, dim=1)
    if not stacking.is_stacked(peft_grads) and stacking.is_stackable(peft_grads):
        peft_grads = stacking.from_layer_list(peft_grads, stacked=True)  # the stacked sums, bit for bit
    if not stacking.is_stacked(peft_grads):
        device = next((x.device for x in stacking.tree_leaves(peft_grads)), None)
        norms = []
        for layer in peft_grads:
            leaves = stacking.tree_leaves(layer)
            sq = sum(torch.sum(torch.square(x.float())) for x in leaves)
            norms.append(torch.sqrt(sq) if leaves else torch.zeros((), dtype=torch.float32, device=device))
        return torch.stack(norms)
    leaves = stacking.tree_leaves(peft_grads)
    if not leaves:
        if num_layers <= 0:
            raise ValueError("layer_grad_norms needs num_layers for a leafless stacked tree (PEFT method 'none')")
        return torch.zeros((num_layers,), dtype=torch.float32)
    sq = sum(torch.sum(torch.square(x.float()), dim=tuple(range(1, x.ndim))) for x in leaves)
    return torch.sqrt(sq)


class ImportanceAccumulator:
    """Running Eq.-6 accumulator over the local batches of one round."""

    @staticmethod
    def init(num_layers: int, device=None, devices: Optional[int] = None):
        """(L,) sums, or (N, L) for a cohort of ``devices`` N, whose
        ``update`` then takes (N, L) norms and drops."""
        device = torch.device("cuda" if device is None else device)
        shape = (num_layers,) if devices is None else (devices, num_layers)
        return {
            "g_sum": torch.zeros(shape, dtype=torch.float32, device=device),
            "count": torch.zeros(shape, dtype=torch.float32, device=device),
        }

    @staticmethod
    def update(state, grad_norms, drops):
        grad_norms = grad_norms.to(state["g_sum"].device)  # a leafless tree's zeros come from the host
        active = 1.0 - drops.to(device=grad_norms.device, dtype=torch.float32)
        return {"g_sum": state["g_sum"] + grad_norms * active, "count": state["count"] + active}

    @staticmethod
    def importance(state):
        return state["g_sum"] / torch.clamp(state["count"], min=1.0)


def shared_layer_mask(importance, k: int) -> torch.Tensor:
    """(L,) bool: True for the k lowest-importance (shared) layers.  The
    sort is stable, as ``jnp.argsort``: tied layers (importance 0 for a
    layer no step activated) are taken in layer order."""
    num_layers = importance.shape[0]
    order = torch.argsort(importance, stable=True)  # ascending: least important first
    mask = torch.zeros((num_layers,), dtype=torch.bool, device=importance.device)
    mask[order[: min(k, num_layers)]] = True
    return mask


def _lead(v, ndim):
    """An (L,) vector shaped to broadcast over an (L, ...) leaf of ``ndim``."""
    return v.reshape((-1,) + (1,) * (ndim - 1))


def masked_layer_mean(updates, masks, prev_global, weights=None):
    """Heterogeneous aggregation (paper Fig. 8), in ``prev_global``'s layout.

    * stacked: ``prev_global`` has ``(L, ...)`` leaves and ``updates``
      ``(N, L, ...)`` leaves; one masked reduction over the device axis per
      leaf.
    * list: ``prev_global`` is a list (len L) of per-layer trees and
      ``updates`` a list (len L) of trees with ``(N, ...)`` leaves.

    ``masks``: (N, L) bool, device n shares layer l.  The mean divides by
    ``max(count, 1)`` and is cast to the previous global's dtype before the
    select, so a layer nobody shared keeps the previous global bit for bit.
    ``weights`` (optional, (N,) positive) makes it a weighted mean, whose
    denominator is guarded by ``where(denom > 0)`` instead.
    """
    weighted = weights is not None
    if isinstance(prev_global, (list, tuple)):
        out = []
        for l, (upd_l, prev_l) in enumerate(zip(updates, prev_global)):
            m = masks[:, l].float()  # (N,)
            if weighted:
                m = m * torch.as_tensor(weights, dtype=torch.float32, device=m.device)
            denom = torch.sum(m)
            safe = torch.where(denom > 0, denom, 1.0) if weighted else torch.clamp(denom, min=1.0)

            def avg(leaf_upd, leaf_prev, m=m, denom=denom, safe=safe):
                w = m.reshape((-1,) + (1,) * (leaf_upd.ndim - 1))
                mean = torch.sum(leaf_upd * w, dim=0) / safe
                return torch.where(denom > 0, mean.to(leaf_prev.dtype), leaf_prev)

            out.append(stacking.tree_map(avg, upd_l, prev_l))
        return out
    m = masks.float()  # (N, L)
    if weighted:
        m = m * torch.as_tensor(weights, dtype=torch.float32, device=m.device)[:, None]
    denom = torch.sum(m, dim=0)  # (L,)
    safe = torch.where(denom > 0, denom, 1.0) if weighted else torch.clamp(denom, min=1.0)

    def avg(leaf_upd, leaf_prev):
        w = m.reshape(m.shape + (1,) * (leaf_upd.ndim - 2))
        mean = torch.sum(leaf_upd * w, dim=0) / _lead(safe, leaf_prev.ndim)
        return torch.where(_lead(denom > 0, leaf_prev.ndim), mean.to(leaf_prev.dtype), leaf_prev)

    return stacking.tree_map(avg, updates, prev_global)
