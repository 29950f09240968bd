"""Name- and divisibility-driven partition specs, as
``repro.sharding.specs``.

Megatron-style tensor parallel over the ``model`` axis with automatic
fallback: a rule proposes which dim of a weight to shard; if that dim is not
divisible by the model-axis size the engine tries the rule's fallback dims
and finally replicates.  One rule set covers all ten archs (llama4's 40
heads, whisper's 6 heads, granite's 40 experts and 49 155-token vocab hit
fallbacks).

Conventions:
  * column-parallel (shard output dim):   wq wk wv gate up router embed
  * row-parallel (shard input dim):       wo down out_proj lm_head-ish
  * expert-parallel: leading expert dim of stacked expert weights
  * PEFT params are replicated (tiny; keeps aggregation collective-free)

A spec is a :class:`PartitionSpec`: a tuple with one entry per tensor dim,
each an axis name, a tuple of axis names or None (replicated along that
dim).  Spec trees mirror the port's nested dicts and lists of tensors (the
keys in sorted order, as the reference's trees flatten); the leaves may be
``meta`` tensors (``models.registry.param_shapes``), so that full-width
shapes cost no memory.  ``to_shardings`` turns specs into DTensor placements
for ``torch.distributed.tensor.distribute_tensor``.
"""
from __future__ import annotations

import math

import torch


class PartitionSpec(tuple):
    """One entry per tensor dim: an axis name, a tuple of names, or None."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec

# rule table: ordered-subsequence key-path match -> ordered dim preferences
# to shard on the "model" axis.  First divisible dim wins; rules are tried
# top-to-bottom, so specific rules (channel_mix) precede generic ones (wv).
_RULES = [
    # (path substrings (ordered subsequence), rank, dim preference order)
    (("channel_mix", "wk", "w"), 2, (1,)),
    (("channel_mix", "wv", "w"), 2, (0,)),
    (("experts", "gate"), 3, (0, 2, 1)),
    (("experts", "up"), 3, (0, 2, 1)),
    (("experts", "down"), 3, (0, 1, 2)),
    (("router",), 2, (1,)),
    (("embed",), 2, (0, 1)),
    (("lm_head",), 2, (1, 0)),
    (("pos_embed",), 2, (1,)),
    (("wq", "w"), 2, (1, 0)),
    (("wk", "w"), 2, (1,)),
    (("wv", "w"), 2, (1,)),
    (("wo", "w"), 2, (0, 1)),
    (("gate", "w"), 2, (1,)),
    (("up", "w"), 2, (1,)),
    (("down", "w"), 2, (0,)),
    (("in_proj", "w"), 2, (1,)),
    (("out_proj", "w"), 2, (0,)),
    (("x_proj", "w"), 2, (0,)),
    (("dt_proj", "w"), 2, (1,)),
    (("conv_w",), 2, (1,)),
    (("conv_b",), 1, (0,)),
    (("A_log",), 2, (0,)),
    (("D",), 1, (0,)),
    (("time_mix", "wr", "w"), 2, (1,)),
]


def _path_parts(path) -> tuple:
    """A key path (dict keys and list indices) as strings."""
    return tuple(str(p) for p in path)


def _match(parts: tuple, needles: tuple) -> bool:
    it = iter(parts)
    return all(any(n == part for part in it) for n in needles)


def _replicated(ndim: int) -> PartitionSpec:
    return P(*([None] * ndim))


def _spec_with_dim(shape, dim: int, tp: int, extra_leading: int = 0) -> PartitionSpec:
    dim = dim % len(shape)
    spec = [None] * len(shape)
    spec[dim + extra_leading] = "model"
    return P(*spec)


def _stacked_layer_lead(parts: tuple) -> int:
    """1 when the leaf lives under a stacked ``layers`` subtree (its shapes
    carry a leading layer axis the per-layer rules must skip), else 0.
    List-layout leaves have an integer index right after ``layers``."""
    for i, p in enumerate(parts):
        if p == "layers":
            nxt = parts[i + 1] if i + 1 < len(parts) else ""
            return 0 if nxt.isdigit() else 1
    return 0


def spec_for_param(path, shape, tp: int, extra_leading: int = 0, expert_shard: str = "auto") -> PartitionSpec:
    """Spec of one weight leaf at key path ``path``.  ``extra_leading``
    counts stacked dims prepended to a per-layer shape; a stacked ``layers``
    subtree (leading layer axis already in ``shape``) is detected from the
    key path and handled the same way.

    ``expert_shard='ff'`` shards stacked expert weights on the within-expert
    dim instead of the expert dim (the decode weight gather reads every
    expert's slice on every shard)."""
    parts, shape = _path_parts(path), tuple(shape)
    if "peft" in parts:
        return _replicated(len(shape))
    lead = _stacked_layer_lead(parts)
    if lead:
        inner = _spec_for_inner(parts, shape[lead:], tp, extra_leading, expert_shard)
        return P(*((None,) * lead + tuple(inner)))
    return _spec_for_inner(parts, shape, tp, extra_leading, expert_shard)


def _spec_for_inner(parts, shape, tp: int, extra_leading: int, expert_shard: str) -> PartitionSpec:
    for needles, rank, prefs in _RULES:
        if expert_shard == "ff" and needles[0] == "experts":
            prefs = tuple(d for d in prefs if d != 0) + (0,)  # the expert dim last
        if len(shape) - extra_leading == rank and _match(parts, needles):
            for dim in prefs:
                if shape[dim + extra_leading] % tp == 0 and shape[dim + extra_leading] >= tp:
                    return _spec_with_dim(shape, dim, tp, extra_leading)
            return _replicated(len(shape))
    # fallback: biases and norms replicate; big 2D+ weights shard the last divisible dim
    if len(shape) - extra_leading >= 2:
        for dim in range(len(shape) - 1, extra_leading - 1, -1):
            if shape[dim] % tp == 0 and shape[dim] >= tp and shape[dim] >= 1024:
                spec = [None] * len(shape)
                spec[dim] = "model"
                return P(*spec)
    return _replicated(len(shape))


def map_with_path(fn, tree, *rest, path=()):
    """``fn(path, leaf, *other_leaves)`` over a tree of dicts (keys sorted)
    and lists, and the trees of the same structure in ``rest``."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, tree[k], *(r[k] for r in rest), path=path + (k,)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [map_with_path(fn, t, *(r[i] for r in rest), path=path + (i,)) for i, t in enumerate(tree)]
    return fn(path, tree, *rest)


def param_specs(params, tp: int, extra_leading: int = 0, fsdp_axes: tuple = (), expert_shard: str = "auto"):
    """Spec tree mirroring ``params``.

    ``fsdp_axes``: data-parallel mesh axes to additionally shard parameters
    over (ZeRO-3 style, for a frozen PEFT base, which carries no optimizer
    state), on the first still-unsharded dim of every large leaf that
    divides the axes' product (``set_mesh_axis_sizes``).
    """
    n_fsdp = _axes_size(fsdp_axes) if fsdp_axes else 1

    def leaf_spec(path, leaf):
        shape = tuple(leaf.shape)
        spec = spec_for_param(path, shape, tp, extra_leading, expert_shard)
        if n_fsdp <= 1 or math.prod(shape) < 1 << 20:
            return spec
        spec_list = list(spec)
        # never shard the stacked layer axis (the layer loop walks it): FSDP
        # belongs on a within-weight dim, as in the list layout
        lead = _stacked_layer_lead(_path_parts(path))
        for dim in range(lead, len(shape)):
            if spec_list[dim] is None and shape[dim] % n_fsdp == 0 and shape[dim] >= n_fsdp:
                spec_list[dim] = fsdp_axes if len(fsdp_axes) > 1 else fsdp_axes[0]
                break
        return P(*spec_list)

    return map_with_path(leaf_spec, params)


def peft_specs(peft_tree):
    """PEFT params replicate (see the module docstring)."""
    return map_with_path(lambda path, leaf: _replicated(len(leaf.shape)), peft_tree)


def batch_spec(batch_axes: tuple, ndim: int, *, batch_dim: int = 0) -> PartitionSpec:
    spec = [None] * ndim
    spec[batch_dim] = batch_axes if len(batch_axes) > 1 else batch_axes[0]
    return P(*spec)


def cache_specs(caches, batch_axes: tuple, tp: int, *, shard_seq_on_data: bool = False):
    """Specs for decode caches (``models.transformer.init_caches``).

    Attention caches (B, S, KV, HD): batch over the data axes; KV heads over
    ``model`` when divisible (else head_dim, else replicate).  When B == 1
    ``shard_seq_on_data=True`` shards the *sequence* dim over the data axes
    instead (distributed long-context decode: ``serving.decode
    .sharded_decode_attention``).  Recurrent states (Mamba, RWKV6) shard
    batch and their channel dim.
    """
    n_batch = _axes_size(batch_axes)
    b_ax = batch_axes if len(batch_axes) > 1 else batch_axes[0]

    def leaf_spec(path, leaf):
        parts, shape = _path_parts(path), tuple(leaf.shape)
        name = parts[-1] if parts else ""
        if name == "pos" or len(shape) == 0:
            return _replicated(len(shape))
        if name in ("k", "v") and len(shape) == 4:
            b, s, kv, hd = shape
            spec = [None, None, None, None]
            if shard_seq_on_data and b == 1:
                spec[1] = b_ax
            elif b % n_batch == 0 and b >= n_batch:
                spec[0] = b_ax
            if kv % tp == 0 and kv >= tp:
                spec[2] = "model"
            elif hd % tp == 0 and hd >= tp:
                spec[3] = "model"
            return P(*spec)
        # recurrent states: (B, ...channels...)
        spec = [None] * len(shape)
        if shape[0] % n_batch == 0 and shape[0] >= n_batch:
            spec[0] = b_ax
        for dim in range(len(shape) - 1, 0, -1):
            if shape[dim] % tp == 0 and shape[dim] >= tp and shape[dim] >= 256:
                spec[dim] = "model"
                break
        return P(*spec)

    return map_with_path(leaf_spec, caches)


_MESH_AXES_SIZES = {}


def set_mesh_axis_sizes(mesh):
    """Record axis sizes so spec builders can check divisibility: a
    ``DeviceMesh`` (its dim names), or any object whose ``shape`` maps axis
    names to sizes."""
    from repro_torch.launch.mesh import axis_sizes

    global _MESH_AXES_SIZES
    _MESH_AXES_SIZES = axis_sizes(mesh)


def _axes_size(axes: tuple) -> int:
    n = 1
    for a in axes:
        n *= _MESH_AXES_SIZES.get(a, 1)
    return n


def placements(mesh, spec: PartitionSpec) -> tuple:
    """DTensor placements of one spec on ``mesh``: per mesh dim,
    ``Shard(d)`` where tensor dim d names that axis (alone or in a tuple),
    else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    dim_of = {}
    for d, entry in enumerate(spec):
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is not None:
                dim_of[axis] = d
    return tuple(Shard(dim_of[name]) if name in dim_of else Replicate() for name in mesh.mesh_dim_names)


def to_shardings(mesh, spec_tree):
    """Spec tree -> a tree of placements tuples, for
    ``distribute_tensor(t, mesh, placements)``."""
    if isinstance(spec_tree, PartitionSpec):
        return placements(mesh, spec_tree)
    if isinstance(spec_tree, dict):
        return {k: to_shardings(mesh, v) for k, v in spec_tree.items()}
    return [to_shardings(mesh, v) for v in spec_tree]


def entry_axes(entry) -> tuple:
    """The mesh axes of one spec entry, major to minor."""
    return tuple(a for a in (entry if isinstance(entry, tuple) else (entry,)) if a is not None)


def ways(entry, sizes: dict, axes=None) -> int:
    """How many ways a spec entry splits its dim over the mesh of axis
    ``sizes`` (only over ``axes``, if given)."""
    return math.prod(sizes[a] for a in entry_axes(entry) if axes is None or a in axes)


def _shard_index(axes: tuple, sizes: dict, coords: dict) -> int:
    """This rank's index along a dim split over ``axes``, the first major
    (as a tuple of mesh axes shards a dim)."""
    i = 0
    for a in axes:
        i = i * sizes[a] + coords[a]
    return i


def _spec_walk(fn, tree, spec_tree):
    if isinstance(spec_tree, PartitionSpec):
        return fn(tree, spec_tree)
    if isinstance(spec_tree, dict):
        return {k: _spec_walk(fn, tree[k], spec_tree[k]) for k in tree}
    return [_spec_walk(fn, t, s) for t, s in zip(tree, spec_tree)]


def shard_tree(tree, spec_tree, sizes: dict, coords: dict):
    """One rank's part of a whole ``tree`` under ``spec_tree``: each leaf
    cut along every dim its spec splits, at the rank's ``coords`` (axis
    name -> index; ``sizes`` axis name -> size), as ``distribute_tensor``
    places it.  Every part is a tensor of its own (a ``meta`` leaf gives a
    ``meta`` part), so the whole tree can be freed."""

    def cut(t, spec):
        index = [slice(None)] * t.ndim
        for d, entry in enumerate(spec):
            n = ways(entry, sizes)
            if n > 1:
                part = t.shape[d] // n
                i = _shard_index(entry_axes(entry), sizes, coords)
                index[d] = slice(i * part, (i + 1) * part)
        return t[tuple(index)].clone(memory_format=torch.contiguous_format)

    return _spec_walk(cut, tree, spec_tree)


def unshard_tree(parts: dict, spec_tree, sizes: dict):
    """The whole tree from every rank's part: ``parts`` maps each rank's
    coordinates (a tuple of indices in the order of ``sizes``) to its
    tree, ``shard_tree``'s inverse."""
    names = tuple(sizes)

    def join(spec, by_coords):
        out = None
        for coords, leaf in by_coords.items():
            coord = dict(zip(names, coords))
            if out is None:
                shape = [n * ways(e, sizes) for n, e in zip(leaf.shape, spec)]
                out = torch.empty(shape, dtype=leaf.dtype, device=leaf.device)
            index = []
            for d, entry in enumerate(spec):
                i = _shard_index(entry_axes(entry), sizes, coord)
                index.append(slice(i * leaf.shape[d], (i + 1) * leaf.shape[d]))
            out[tuple(index)] = leaf
        return out

    def walk(spec_tree, subtrees):
        if isinstance(spec_tree, PartitionSpec):
            return join(spec_tree, subtrees)
        if isinstance(spec_tree, dict):
            return {k: walk(spec_tree[k], {c: t[k] for c, t in subtrees.items()}) for k in spec_tree}
        return [walk(s, {c: t[i] for c, t in subtrees.items()}) for i, s in enumerate(spec_tree)]

    return walk(spec_tree, parts)
