"""The two layouts of a layer stack, as in ``repro.models.stacking``:

* **stacked** -- one tree whose leaves carry a leading ``(L, ...)`` layer
  axis (homogeneous stacks: the dense and RWKV6 decoders);
* **list** -- one tree per layer (heterogeneous stacks: jamba's
  Mamba/attention and MoE/MLP interleave).

The port's layer loop runs in Python over ``layer_view(tree, l)``, a slice
view in the stacked layout and the layer's own tree in the list layout.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from repro_torch.nn.linear import AdapterPool


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` to every leaf of a tree of dicts, lists and
    ``AdapterPool``s; with ``rest``, to the matching leaves of trees of the
    same structure (``fn(leaf, *other_leaves)``), as ``jax.tree.map``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, *parts) for parts in zip(tree, *rest)]
    if isinstance(tree, AdapterPool):
        return AdapterPool(**{f.name: fn(getattr(tree, f.name), *(getattr(r, f.name) for r in rest))
                              for f in dataclasses.fields(tree)})
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    leaves = []
    tree_map(leaves.append, tree)
    return leaves


def _signature(tree):
    """Structure, shapes and dtypes of a tree (dict keys sorted)."""
    if isinstance(tree, dict):
        return tuple((k, _signature(tree[k])) for k in sorted(tree))
    return (tuple(tree.shape), tree.dtype)


def is_stackable(trees: Sequence) -> bool:
    """True when every per-layer tree has one structure and one leaf shape
    and dtype (a homogeneous stack)."""
    return len({_signature(t) for t in trees}) <= 1


def _stack(trees: Sequence):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(list(trees))


LAYOUTS = ("auto", "stacked", "list")


def check_layout(layout: str):
    """``ValueError`` for a layer layout that is not one of ``LAYOUTS``."""
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layer layout {layout!r}")


def maybe_stack(layers: Sequence, layout: str = "auto"):
    """A freshly built per-layer list in an init-time ``layout``, as the
    reference's ``maybe_stack``: ``auto`` stacked when homogeneous and the
    list otherwise, ``stacked`` stacked (``ValueError`` for a heterogeneous
    list), ``list`` the list; any other layout raises ``ValueError``."""
    if layout == "list":
        return list(layers)
    if layout == "stacked":
        return stack_params(layers)
    check_layout(layout)
    return _stack(layers) if layers and is_stackable(layers) else list(layers)


def in_layout(layers, layout: str, num_layers: int):
    """A stack of ``num_layers`` drawn in either layout, in ``layout``
    (``maybe_stack``'s policy): a stacked draw stays as it is under
    ``auto`` and ``stacked`` and is cut into per-layer copies under
    ``list``, so every layout holds the same numbers."""
    if not is_stacked(layers):
        return maybe_stack(layers, layout)
    check_layout(layout)
    if layout != "list":
        return layers
    return [tree_map(lambda x: x[l].clone(), layers) for l in range(num_layers)]


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


def select_layers(mask, take_tree, keep_tree, axis: int = 0):
    """Per-layer select on stacked trees: layer ``l`` comes from
    ``take_tree`` where ``mask[l]`` else from ``keep_tree``.  ``axis`` is
    the layer axis (1 for cohort-stacked ``(N, L, ...)`` leaves).  Exact
    copies (``torch.where`` on a bool mask), so it is bit-identical to the
    list-layout per-layer selection."""
    mask = torch.as_tensor(mask, dtype=torch.bool)

    def pick(t, k):
        m = mask.to(t.device).reshape((1,) * axis + tuple(mask.shape) + (1,) * (t.ndim - axis - 1))
        return torch.where(m, t, k)

    return tree_map(pick, take_tree, keep_tree)


def stack_params(layers: Sequence):
    """The list layout into the stacked layout (``from_layer_list``), as the
    reference's ``stack_params``: a stacked tree comes back as it is, and a
    heterogeneous list raises ``ValueError``."""
    if is_stacked(layers):
        return layers
    if not is_stackable(layers):
        raise ValueError("cannot stack a heterogeneous layer list (per-layer structures or shapes differ); keep "
                         "the list layout for this stack")
    return from_layer_list(layers, stacked=True)


def unstack_params(layers, num_layers: Optional[int] = None) -> list:
    """The stacked layout into the list layout (``layer_list``), as the
    reference's ``unstack_params``; ``num_layers`` is needed only for a
    leafless stacked tree."""
    if not is_stacked(layers):
        return list(layers)
    n = num_layers if num_layers is not None else stack_size(layers)
    if n is None:
        raise ValueError("cannot infer layer count of a leafless stacked tree")
    return layer_list(layers, n)


def layer_list(tree, num_layers: int, axis: int = 0) -> list:
    """A tree in either layout as a per-layer list: the list layout as it
    is, the stacked layout's layer ``axis`` (1 for a cohort's ``(N, L,
    ...)`` leaves) cut into contiguous per-layer copies, so that each layer
    is a leaf of its own for autograd."""
    if not is_stacked(tree):
        return list(tree)
    return [tree_map(lambda x: x.select(axis, l).contiguous(), tree) for l in range(num_layers)]


def from_layer_list(layers: Sequence, stacked: bool, axis: int = 0):
    """The inverse of ``layer_list``: the layers stacked on ``axis`` when
    ``stacked``, else the list."""
    if not stacked:
        return list(layers)
    return tree_map(lambda *xs: torch.stack(xs, dim=axis), *layers)
