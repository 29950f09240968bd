"""``meta``-device inputs and partition specs for every (arch x shape x
step), as ``repro.launch.input_specs``.

Nothing here allocates: parameters, PEFT trees, optimizer states and decode
caches are built by the real init functions on the ``meta`` device
(``models.registry.param_shapes``/``peft_shapes``, ``optim.adamw_init``,
``init_caches(..., device="meta")``), so the dry run
(``repro_torch.launch.dryrun``) runs the port's own step functions on them.
The specs come from ``sharding.specs`` and the mesh's axis sizes from
``launch.mesh.production_mesh_shape``, with no process group
(:class:`MeshShape`).

Where the torch idiom differs from the reference's trees: tokens are int32
as there; the train step's ``rng`` is a CPU ``torch.Generator`` (spec
``P()``) where the reference takes a (2,) uint32 key; the serve step's
``pos`` is a Python int (spec ``P()``), the position it decodes at (the last
slot of its cache, where the caches' own scalar positions stand too: a
decode step reads the whole ring), where the reference takes an abstract
int32 scalar.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import InputShape
from repro_torch.launch.mesh import axis_sizes, data_axes, production_mesh_shape
from repro_torch.models import encdec
from repro_torch.models.registry import param_shapes, peft_shapes, place_params
from repro_torch.models.transformer import init_caches
from repro_torch.optim import adamw_init
from repro_torch.sharding import specs as sharding_specs
from repro_torch.sharding.specs import P

WEIGHTS_DTYPES = ("float32", "bfloat16", "placed")


class MeshShape:
    """A mesh's axis names and sizes without devices or a process group:
    what the spec functions read (``launch.mesh.axis_sizes``)."""

    def __init__(self, sizes: dict):
        self.shape = dict(sizes)

    def __repr__(self):
        return f"MeshShape({self.shape})"


def production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """The production mesh's axis sizes: 16 x 16, or 2 x 16 x 16."""
    shape, axes = production_mesh_shape(multi_pod=multi_pod)
    return MeshShape(dict(zip(axes, shape)))


def _empty(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def eval_param_shapes(cfg):
    return param_shapes(cfg)


def eval_peft_shapes(cfg, peft_cfg):
    return peft_shapes(cfg, peft_cfg)


def eval_cache_shapes(cfg, batch: int, max_len: int):
    return init_caches(cfg, batch, max_len, device="meta")


def _modality_extras(cfg, batch: int):
    if cfg.frontend_key is None:
        return {}
    return {cfg.frontend_key: _empty((batch, cfg.frontend_seq, cfg.d_model), getattr(torch, cfg.dtype))}


def _batch_axes_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    n = 1
    for a in data_axes(mesh):
        n *= sizes[a]
    return n


def _cast_params(params, cfg, weights_dtype: str):
    """The base weights as served: ``float32`` as drawn, ``bfloat16`` every
    floating leaf cast (the reference's serving cast), ``placed`` as
    ``models.registry.place_params`` places them on the card (the matmul
    weights in ``cfg.dtype``, the norms float32)."""
    if weights_dtype not in WEIGHTS_DTYPES:
        raise ValueError(f"weights_dtype must be one of {WEIGHTS_DTYPES}, got {weights_dtype!r}")
    if weights_dtype == "placed":
        return place_params(params, cfg, "meta")
    dtype = getattr(torch, weights_dtype)

    def cast(tree):
        if isinstance(tree, dict):
            return {k: cast(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [cast(v) for v in tree]
        return tree.to(dtype) if tree.dtype.is_floating_point else tree

    return cast(params)


def train_inputs(cfg, peft_cfg, shape: InputShape, mesh, *, fsdp: bool = False,
                 weights_dtype: str = "float32") -> Tuple[tuple, tuple]:
    """(args, specs) of ``make_train_step``'s step: ``(base, peft, opt_state,
    batch, rng)``.  ``weights_dtype`` as ``_cast_params`` (the reference's
    train step takes the float32 tree)."""
    sharding_specs.set_mesh_axis_sizes(mesh)
    tp = axis_sizes(mesh)["model"]
    b_axes = data_axes(mesh)

    base = _cast_params(eval_param_shapes(cfg), cfg, weights_dtype)
    peft = eval_peft_shapes(cfg, peft_cfg)
    opt = adamw_init(peft)
    batch = {"tokens": _empty((shape.global_batch, shape.seq_len + 1), torch.int32),
             **_modality_extras(cfg, shape.global_batch)}
    rng = torch.Generator()

    base_s = sharding_specs.param_specs(base, tp, fsdp_axes=b_axes if fsdp else ())
    peft_s = sharding_specs.peft_specs(peft)
    opt_s = {"m": peft_s, "v": peft_s, "count": P()}
    batch_s = {k: sharding_specs.batch_spec(b_axes, v.ndim) for k, v in batch.items()}
    return (base, peft, opt, batch, rng), (base_s, peft_s, opt_s, batch_s, P())


def rank_slice(tree, spec_tree, mesh, axes=None):
    """``tree`` (``meta`` leaves) as one rank holds it: every dim that its
    spec shards over ``axes`` (default the data axes) divided by their
    sizes; a leaf off ``meta`` (a scalar position on the host) as it is."""
    sizes = axis_sizes(mesh)
    axes = data_axes(mesh) if axes is None else axes
    if isinstance(spec_tree, P):
        if tree.device.type != "meta":
            return tree
        return _empty([d // sharding_specs.ways(e, sizes, axes) for d, e in zip(tree.shape, spec_tree)], tree.dtype)
    if isinstance(tree, dict):
        return {k: rank_slice(v, spec_tree[k], mesh, axes) for k, v in tree.items()}
    return [rank_slice(v, s, mesh, axes) for v, s in zip(tree, spec_tree)]


def rank_train_inputs(cfg, peft_cfg, shape: InputShape, mesh, *, fsdp: bool = False,
                      weights_dtype: str = "float32"):
    """One rank's arguments of the sharded train step
    (``make_train_step(mesh=...)``; every rank's have these shapes):
    ``train_inputs``' trees with the base params cut over every axis of the
    mesh by their specs and the batch over the data axes, the PEFT tree and
    optimizer state whole.  Returns (args, specs, the rank's args, the
    TP-only ``regather_specs`` with ``fsdp``, else None)."""
    args, specs = train_inputs(cfg, peft_cfg, shape, mesh, fsdp=fsdp, weights_dtype=weights_dtype)
    base, peft, opt, batch, rng = args
    local = (rank_slice(base, specs[0], mesh, tuple(axis_sizes(mesh))), peft, opt, rank_slice(batch, specs[3], mesh),
             rng)
    regather = sharding_specs.param_specs(base, axis_sizes(mesh)["model"]) if fsdp else None
    return args, specs, local, regather


def set_cache_position(caches, pos: int):
    """``caches`` (``init_caches``' list) with every scalar-position ring
    at ``pos``, the position of the token a serve step decodes: the ring
    holds the ``pos`` tokens before it, and the step reads it whole.  The
    positions stay on the host."""
    for cache in caches:
        if isinstance(cache, dict) and "pos" in cache:
            cache["pos"] = torch.full_like(cache["pos"], pos)
    return caches


def _cache_len(cfg, shape: InputShape) -> int:
    """A vision model's caches hold its patch prefix too."""
    return shape.seq_len + (cfg.frontend_seq if cfg.modality == "vision" else 0)


def prefill_inputs(cfg, shape: InputShape, mesh, *, weights_dtype: str = "float32") -> Tuple[tuple, tuple]:
    """(args, specs) of ``make_prefill_step``'s step: ``(params, batch,
    caches)``."""
    sharding_specs.set_mesh_axis_sizes(mesh)
    tp = axis_sizes(mesh)["model"]
    b_axes = data_axes(mesh)
    b = shape.global_batch

    params = _cast_params(eval_param_shapes(cfg), cfg, weights_dtype)
    caches = eval_cache_shapes(cfg, b, _cache_len(cfg, shape))
    batch = {"tokens": _empty((b, shape.seq_len), torch.int32), **_modality_extras(cfg, b)}
    params_s = sharding_specs.param_specs(params, tp)
    caches_s = sharding_specs.cache_specs(caches, b_axes, tp)
    batch_s = {k: sharding_specs.batch_spec(b_axes, v.ndim) for k, v in batch.items()}
    return (params, batch, caches), (params_s, batch_s, caches_s)


def rank_prefill_inputs(cfg, shape: InputShape, mesh, *, weights_dtype: str = "float32"):
    """One rank's arguments of the sharded prefill step
    (``make_prefill_step(mesh=...)``): ``prefill_inputs``' trees, each leaf
    cut over every axis its spec names (the weights over ``model``, the
    batch's rows over the data axes, the caches by ``cache_specs``).
    Returns (args, specs, the rank's args)."""
    args, specs = prefill_inputs(cfg, shape, mesh, weights_dtype=weights_dtype)
    every = tuple(axis_sizes(mesh))
    return args, specs, tuple(rank_slice(a, s, mesh, every) for a, s in zip(args, specs))


def serve_shards_seq(shape: InputShape, mesh) -> bool:
    """Whether a decode's caches cut their sequence over the data axes: at
    a batch smaller than the data axes (``long_500k``), as the reference's
    ``serve_inputs`` decides."""
    return shape.global_batch < _batch_axes_size(mesh)


def rank_serve_inputs(cfg, shape: InputShape, mesh, *, weights_dtype: str = "float32", expert_shard: str = "auto"):
    """One rank's arguments of the sharded serve step
    (``make_serve_step(mesh=..., shard_seq=serve_shards_seq(shape,
    mesh))``): ``serve_inputs``' trees, each leaf cut over every axis its
    spec names (the weights over ``model``, the token's rows and the
    caches' rows or, at ``long_500k``, their sequence over the data axes,
    the caches' KV heads or head dim over ``model``); ``pos`` is the
    global position.  Returns (args, specs, the rank's args)."""
    args, specs = serve_inputs(cfg, shape, mesh, weights_dtype=weights_dtype, expert_shard=expert_shard)
    every = tuple(axis_sizes(mesh))
    return args, specs, tuple(a if isinstance(a, int) else rank_slice(a, s, mesh, every) for a, s in zip(args, specs))


def serve_inputs(cfg, shape: InputShape, mesh, *, weights_dtype: str = "float32",
                 expert_shard: str = "auto") -> Tuple[tuple, tuple]:
    """(args, specs) of ``make_serve_step``'s step: ``(params, token, pos,
    caches)`` and, for an encoder-decoder, ``enc_kvs``: ONE new token
    against a cache of ``seq_len``.  At a batch smaller than the data axes
    (``long_500k``) the caches' sequence is sharded over them instead."""
    sharding_specs.set_mesh_axis_sizes(mesh)
    tp = axis_sizes(mesh)["model"]
    b_axes = data_axes(mesh)
    b = shape.global_batch
    shard_seq = serve_shards_seq(shape, mesh)

    cache_len = _cache_len(cfg, shape)
    pos = cache_len - 1
    params = _cast_params(eval_param_shapes(cfg), cfg, weights_dtype)
    caches = set_cache_position(eval_cache_shapes(cfg, b, cache_len), pos)
    token = _empty((b, 1), torch.int32)

    params_s = sharding_specs.param_specs(params, tp, expert_shard=expert_shard)
    caches_s = sharding_specs.cache_specs(caches, b_axes, tp, shard_seq_on_data=shard_seq)
    token_s = sharding_specs.batch_spec(b_axes, 2) if not shard_seq else P(None, None)
    args = [params, token, pos, caches]
    specs = [params_s, token_s, P(), caches_s]
    if cfg.is_encoder_decoder:
        enc_out = _empty((b, cfg.frontend_seq, cfg.d_model), getattr(torch, cfg.dtype))
        enc_kvs = encdec.encoder_cross_kvs(params, cfg, enc_out)
        args.append(enc_kvs)
        specs.append(sharding_specs.cache_specs(enc_kvs, b_axes, tp))
    return tuple(args), tuple(specs)
