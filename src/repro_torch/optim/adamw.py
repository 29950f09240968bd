"""Functional AdamW (and SGD with momentum) over trees of tensors, as
``repro.optim.adamw``.

The frozen base holds no optimizer state: only the PEFT tree (float32) has
moments, which is the memory argument of paper Fig. 3.  The update is the
reference's ``p - lr * (step + wd * p)`` (not ``torch.optim.AdamW``, which
orders the same arithmetic differently).  Trees are in either layout of
``models.stacking``: stacked, or a per-layer list (a hybrid stack).

A cohort's tree (``devices``) is a per-layer list whose leaves carry a
leading (N,) device axis: the clip takes one norm per device and AdamW one
learning rate per device, each device's arithmetic that of its own tree.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.stacking import from_layer_list, is_stackable, is_stacked, tree_leaves, tree_map


def _global_sq_sum(grads, devices=None):
    """Sum of squares over every element, in the reference's order.
    Stacked layout: per-leaf trailing-axis sums give (L,) partials,
    arranged (L, leaves) and summed as one flat vector (layer-major).  A
    per-layer list of one structure (``layout="list"``) is stacked first,
    so it sums as the stacked layout does; a heterogeneous stack's list:
    one scalar sum per leaf, stacked and summed.  A cohort (``devices`` N): each leaf's (N,) sums, arranged
    (N, layers x leaves) layer-major and summed per device."""
    if not is_stacked(grads) and devices is None and is_stackable(grads):
        grads = from_layer_list(grads, stacked=True)  # a homogeneous list: the stacked sums, bit for bit
    leaves = [g.float() for g in tree_leaves(grads)]
    if not leaves:  # PEFT method none: on the host, as no leaf names a device
        return torch.zeros(() if devices is None else (devices,), dtype=torch.float32)
    if devices is not None:
        parts = [torch.sum(torch.square(g), dim=tuple(range(1, g.ndim))) for g in leaves]
        return torch.sum(torch.stack(parts, dim=-1), dim=-1)
    if not is_stacked(grads):
        return torch.sum(torch.stack([torch.sum(torch.square(g)) for g in leaves]))
    parts = [torch.sum(torch.square(g), dim=tuple(range(1, g.ndim))) for g in leaves]
    return torch.sum(torch.stack(parts, dim=-1).reshape(-1))


def clip_by_global_norm(grads, max_norm: float, devices=None):
    """Scale ``grads`` so that their global L2 norm is at most ``max_norm``.
    Returns (clipped grads, the norm before clipping) without a host sync.
    A cohort (``devices`` N): each device's tree apart, the norms (N,)."""
    gnorm = torch.sqrt(_global_sq_sum(grads, devices))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g * _lead(scale, g)).to(g.dtype), grads), gnorm


def _lead(v, t):
    """A scalar, or an (N,) per-device vector shaped to broadcast over the
    leading device axis of ``t``."""
    if isinstance(v, torch.Tensor) and v.ndim == 1:
        return v.to(t.device).reshape((-1,) + (1,) * (t.ndim - 1))
    return v


def adamw_init(params):
    return {
        "m": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
        "v": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
        "count": 0,
    }


def adamw_update(grads, state, params, *, lr, beta1: float = 0.9, beta2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.01):
    """One AdamW step.  Returns (new params, new state); nothing is updated
    in place.  ``count`` is a host integer, so the bias corrections are
    host scalars, computed in float32 as the reference computes them.
    ``lr`` is a float, or for a cohort an (N,) float32 tensor of each
    device's rate, broadcast over the leaves' leading device axis (every
    device starts fresh, so one count serves them all)."""
    count = state["count"] + 1
    f32 = np.float32
    b1c = float(f32(1.0) - f32(beta1) ** f32(count))
    b2c = float(f32(1.0) - f32(beta2) ** f32(count))

    def upd(g, m, v, p):
        g = g.float()
        m2 = beta1 * m + (1 - beta1) * g
        v2 = beta2 * v + (1 - beta2) * torch.square(g)
        step = (m2 / b1c) / (torch.sqrt(v2 / b2c) + eps)
        pf = p.float()
        return m2, v2, (pf - _lead(lr, pf) * (step + weight_decay * pf)).to(p.dtype)

    flat = tree_map(upd, grads, state["m"], state["v"], params)
    return _pick(flat, 2), {"m": _pick(flat, 0), "v": _pick(flat, 1), "count": count}


def sgdm_init(params):
    return {"mom": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)}


def sgdm_update(grads, state, params, *, lr, momentum: float = 0.9):
    """One step of SGD with momentum, as the reference's:
    ``m = momentum * m + g``, ``p = p - lr * m`` (float32, cast back)."""

    def upd(g, m, p):
        m2 = momentum * m + g.float()
        return m2, (p.float() - lr * m2).to(p.dtype)

    flat = tree_map(upd, grads, state["mom"], params)
    return _pick(flat, 1), {"mom": _pick(flat, 0)}


def _pick(tree, i):
    """Element ``i`` of every tuple leaf of ``tree``."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(v, i) for v in tree]
    return tree[i]
