"""Stacked layer layout: one tree whose leaves carry a leading ``(L, ...)``
layer axis, as in ``repro.models.stacking``.  The port's layer loop runs in
Python over ``layer_view(tree, l)`` slices, which are views."""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.nn.linear import AdapterPool


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every leaf of a tree of dicts and ``AdapterPool``s."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, AdapterPool):
        return AdapterPool(**{f.name: fn(getattr(tree, f.name)) for f in dataclasses.fields(tree)})
    return fn(tree)


def tree_leaves(tree) -> list:
    leaves = []
    tree_map(leaves.append, tree)
    return leaves


def is_stacked(layers) -> bool:
    """True for the stacked (single-tree) layout, False for a per-layer list."""
    return not isinstance(layers, (list, tuple))


def stack_size(layers) -> Optional[int]:
    """Number of layers in either layout (None for a leafless stacked tree)."""
    if not is_stacked(layers):
        return len(layers)
    leaves = tree_leaves(layers)
    return int(leaves[0].shape[0]) if leaves else None


def layer_view(layers, l: int):
    """Layer ``l`` as a per-layer tree (slice views in the stacked layout)."""
    if not is_stacked(layers):
        return layers[l]
    return tree_map(lambda x: x[l], layers)
