"""Step functions: the PEFT train step, the prefill step and the serving
step.

``stld_mode`` of the train step selects the paper semantics:
  * ``off``  — plain PEFT fine-tuning, every layer runs;
  * ``cond`` — paper-faithful STLD: Bernoulli gates drawn on the host each
    step, a dropped layer skipped by a Python branch;
  * ``gather`` — a static count of active layers
    (``stld.static_active_count``), their indices drawn each step (Gumbel
    top-k); the other layers are skipped as in ``cond``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import peft as peft_lib
from repro_torch.core import stld
from repro_torch.core.schedules import unit_shape
from repro_torch.models.losses import softmax_xent, vocab_parallel_argmax
from repro_torch.models import encdec
from repro_torch.models.registry import model_apply, param_shapes, params_device
from repro_torch.models.stacking import is_stacked, tree_leaves, tree_map
from repro_torch.models.transformer import check_stack_mode
from repro_torch.optim import adamw_update, clip_by_global_norm
from repro_torch.sharding import collectives
from repro_torch.sharding import specs as sharding_specs


def value_and_grad(fn):
    """``fn(peft, *args) -> (loss, aux dict)`` into ``(peft, *args) -> ((loss,
    aux), grads)``: the gradient of the loss with respect to every leaf of
    the PEFT tree (zeros for a leaf the loss does not reach), as
    ``jax.value_and_grad(fn, has_aux=True)``.  The other arguments take no
    gradient."""

    def wrapped(peft_params, *args):
        params = tree_map(lambda p: p.detach().requires_grad_(True), peft_params)
        loss, aux = fn(params, *args)
        leaves = tree_leaves(params)
        aux = {k: v.detach() if isinstance(v, torch.Tensor) else v for k, v in aux.items()}
        if not leaves:  # PEFT method none: nothing trains
            return (loss.detach(), aux), params
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = iter(torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads))
        return (loss.detach(), aux), tree_map(lambda _: next(grads), params)

    return wrapped


def as_device_tensor(x, device):
    """A batch array (numpy or tensor) as a tensor on ``device``."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device)


def frontend_batch(cfg, tokens, frontend=None):
    """``{"tokens": tokens}`` and, for an audio or vision model, its stub
    frontend's input: ``frontend`` (frames or patches, (*tokens.shape[:-1],
    frontend_seq, d_model)) or, where it is None, zeros in ``cfg.dtype`` on
    the tokens' device, as the reference's client and serving CLI give
    them."""
    batch = {"tokens": tokens}
    name = cfg.frontend_key
    if name is not None:
        if frontend is None:
            device = tokens.device if isinstance(tokens, torch.Tensor) else None
            frontend = torch.zeros((*tokens.shape[:-1], cfg.frontend_seq, cfg.d_model), dtype=getattr(torch, cfg.dtype),
                                   device=device)
        batch[name] = frontend
    return batch


def model_batch(cfg, batch, tokens, device):
    """``{"tokens": tokens}`` plus the batch's stub-frontend input, if it
    has one, on ``device``."""
    out = {"tokens": tokens}
    if cfg.frontend_key in batch:
        out[cfg.frontend_key] = as_device_tensor(batch[cfg.frontend_key], device)
    return out


def token_logits(cfg, logits, num_tokens: int):
    """The logits of the token positions: a vision model's patch prefix
    positions stripped, as the reference strips them."""
    return logits[:, -num_tokens:] if cfg.prefix_len else logits


def _tp_layout(comm, base_params, regather_specs, full_shapes):
    """This rank's base params as its tensor-parallel step reads them,
    from the part it holds between steps: with ``regather_specs`` (the
    TP-only specs) each leaf that the FSDP specs also cut over the data
    axes gathered over them, once a step (the reference's
    ``with_sharding_constraint`` to ``regather_specs``); then, where
    ``wk`` and ``wv``'s column shards cut a KV head, the head gathered
    from the ranks that share it (``Comm.kv_cols``)."""
    if regather_specs is not None:
        sizes = comm.sizes

        def regather(path, t, spec, full):
            want = [n // sharding_specs.ways(e, sizes) for n, e in zip(full.shape, spec)]
            cut = [d for d, (n, w) in enumerate(zip(t.shape, want)) if n != w]
            if not cut:
                return t
            if len(cut) > 1 or t.shape[cut[0]] * comm.n_data != want[cut[0]]:
                raise ValueError(f"{'/'.join(map(str, path))}: a part of shape {tuple(t.shape)} for the "
                                 f"tensor-parallel shape {tuple(want)} over {comm.n_data} data ranks")
            return comm.all_gather(t, "data", cut[0])

        base_params = sharding_specs.map_with_path(regather, base_params, regather_specs, full_shapes)
    if comm.head_share > 1:
        def heads(path, t):
            return comm.all_gather(t, "heads", -1) if path[-3:-1] in (("attn", "wk"), ("attn", "wv")) and \
                path[-1] == "w" else t

        base_params = sharding_specs.map_with_path(heads, base_params)
    return base_params


def make_train_step(cfg, peft_cfg, train_cfg, *, stld_mode: str = "off", mean_rate: float = 0.5,
                    distribution: str = "incremental", stack_mode: str = "unroll", shape=None,
                    gather_bucket: int = 4, remat: bool = False, mesh=None, regather_specs=None):
    """Next-token LM fine-tuning step over the PEFT params.

    ``(base_params, peft_params, opt_state, batch, rng) -> (peft_params,
    opt_state, metrics)`` with ``batch = {"tokens": (B, S+1)}`` (plus
    ``frames`` (B, S_enc, d) for an encoder-decoder or ``patches`` (B, P,
    d) for a vision model; numpy or tensors; they go to the device of the
    base params) and ``rng`` a CPU ``torch.Generator`` that the STLD gates
    (or gather indices) draw from.  A vision model's prefix logits are
    stripped before the loss.

    ``shape`` is the (L,) per-layer rate shape (mean 1.0, unclipped) scaled
    by ``mean_rate``.  None takes ``unit_shape(distribution, L)`` with a
    torch generator seeded 0, never the global generator, so two calls give
    the same rates.  For ``normal`` that noise is not the reference's
    ``PRNGKey(0)`` draw: pass the JAX package's ``unit_shape("normal", L)``
    to get its rates.

    ``stack_mode`` is the reference's (``unroll``, ``scan``, ``group``),
    run on the one layer loop; with ``stld_mode="gather"`` the step runs
    ``gather``, as the reference's does.  ``remat`` recomputes each active
    layer's forward in the backward (``transformer.stack_apply``): the
    same step, bit for bit, holding one layer's activations at a time.

    ``mesh`` runs the step sharded, as the reference's step compiled over a
    mesh: a ``DeviceMesh`` with dims (``pod``,) (``data``,) ``model`` (each
    rank of it calls the step with its own arguments), or a mesh's axis
    sizes alone (``launch.input_specs.MeshShape``: rank 0 of that mesh on
    ``meta``, communicating nothing, for the dry run).  Between steps a
    rank holds its part of each tree under the reference's specs
    (``sharding.specs``, cut by ``shard_tree``): the base params by
    ``param_specs(base, tp, fsdp_axes=...)``, the PEFT params and the AdamW
    state whole (``peft_specs``), the batch its rows over the data axes.
    The dense family runs Megatron tensor parallelism over ``model``
    (``sharding.collectives``; ``attention_apply``, ``mlp_apply``,
    ``lm_apply``, ``softmax_xent``), its LoRA gradients summed over
    ``model`` and averaged over the data axes in one ``all_reduce``, so
    that every rank clips and steps the same full gradients and its PEFT
    tree stays bit-identical to every other rank's; the loss and metrics
    are the global batch's.  ``regather_specs`` (the TP-only specs, the
    port's counterpart of the reference's ``NamedSharding`` tree) takes
    base params sharded over the data axes too (FSDP) and gathers them over
    the data axes once, at the step's start.  Each rank draws its gates (or
    gather indices) from its own ``rng``, seeded alike on every rank; the
    step raises where the ranks' gates differ.  Another family, or a PEFT
    method other than LoRA (or none), raises ``NotImplementedError``.

    The step carries ``loss_and_grads`` (``(base, peft, batch, rng) ->
    (metrics, grads)``: the gradients it clips, each rank's full) and
    ``comm`` (the mesh's ``Comm``, or None), whose ``counts`` add up the
    bytes the step communicates.
    """
    if stld_mode not in ("off", "cond", "gather"):
        raise ValueError(f"stld_mode must be 'off', 'cond' or 'gather', got {stld_mode!r}")
    check_stack_mode(stack_mode)
    lora_sc = peft_lib.lora_scale(peft_cfg) if peft_cfg.method == "lora" else 1.0
    rates = None
    if stld_mode != "off":
        if shape is None:
            shape = unit_shape(distribution, cfg.num_layers, generator=torch.Generator().manual_seed(0))
        rates = torch.clamp(torch.as_tensor(shape, dtype=torch.float32) * mean_rate, 0.0, 0.95)
    num_active = stld.static_active_count(mean_rate, cfg.num_layers, gather_bucket) if stld_mode == "gather" else None
    comm = full_shapes = None
    if mesh is not None:
        if cfg.family != "dense":
            raise NotImplementedError(f"the sharded train step runs the dense family, not {cfg.family!r}")
        if peft_cfg.method not in ("lora", "none"):
            raise NotImplementedError(f"the sharded train step trains LoRA, not {peft_cfg.method!r}")
        comm = collectives.comm_for(mesh)
        comm.set_heads(cfg)
        if regather_specs is not None:
            # the whole shapes in both layer layouts, by whether the stack is stacked; drawn here on meta,
            # so that the step allocates none
            full_shapes = {is_stacked(t["layers"]): t for t in (param_shapes(cfg), param_shapes(cfg, "list"))}
    elif regather_specs is not None:
        raise ValueError("regather_specs gathers a sharded step's base params: pass the mesh")

    def loss_fn(peft_params, base_params, inputs, targets, drops, active_idx=None):
        logits, aux, _ = model_apply(base_params, cfg, inputs, drops=drops, peft=peft_params,
                                     lora_scale=lora_sc, stack_mode=stack_mode if active_idx is None else "gather",
                                     active_idx=active_idx, remat=remat, tp=comm)
        loss, metrics = softmax_xent(token_logits(cfg, logits, targets.shape[1]), targets, tp=comm)
        return loss + cfg.router_aux_coef * aux, metrics

    grad_fn = value_and_grad(loss_fn)

    def loss_and_grads(base_params, peft_params, batch, rng):
        device = params_device(base_params)
        if comm is not None:
            shapes = None if full_shapes is None else full_shapes[is_stacked(base_params["layers"])]
            base_params = _tp_layout(comm, base_params, regather_specs, shapes)
        tokens = as_device_tensor(batch["tokens"], device)
        drops = active_idx = None
        if stld_mode == "cond":
            drops = stld.sample_drops(rng, rates, 1)
        elif stld_mode == "gather":
            active_idx = stld.sample_active_indices(rng, rates, num_active)
        if comm is not None:
            comm.check_gates(drops if active_idx is None else active_idx)
        (_, metrics), grads = grad_fn(peft_params, base_params, model_batch(cfg, batch, tokens[:, :-1], device),
                                      tokens[:, 1:], drops, active_idx)
        if comm is not None:
            leaves = iter(comm.mean_grads(tree_leaves(grads)))
            grads = tree_map(lambda _: next(leaves), grads)
            metrics = comm.global_metrics(metrics)
        return metrics, grads

    def train_step(base_params, peft_params, opt_state, batch, rng):
        metrics, grads = loss_and_grads(base_params, peft_params, batch, rng)
        grads, gnorm = clip_by_global_norm(grads, train_cfg.grad_clip)
        peft_params, opt_state = adamw_update(
            grads, opt_state, peft_params, lr=train_cfg.learning_rate, beta1=train_cfg.beta1,
            beta2=train_cfg.beta2, eps=train_cfg.eps, weight_decay=train_cfg.weight_decay,
        )
        return peft_params, opt_state, dict(metrics, grad_norm=gnorm)

    train_step.loss_and_grads, train_step.comm = loss_and_grads, comm
    return train_step


def _serve_comm(cfg, mesh, shard_seq: bool):
    """The ``Comm`` of a sharded serving step (None without a mesh), with
    ``seq_shard``; the dense family only."""
    if mesh is None:
        if shard_seq:
            raise ValueError("shard_seq cuts a sharded step's caches over the data axes: pass the mesh")
        return None
    if cfg.family != "dense":
        raise NotImplementedError(f"the sharded serving steps run the dense family, not {cfg.family!r}")
    comm = collectives.comm_for(mesh)
    comm.set_heads(cfg)
    comm.seq_shard = shard_seq
    return comm


def make_prefill_step(cfg, *, stack_mode: str = "unroll", mesh=None, shard_seq: bool = False):
    """The prompt into the decode caches, as the reference's
    ``make_prefill_step``: ``(params, batch, caches) -> (last_logits (B, V),
    caches)`` with ``batch = {"tokens": (B, S)}`` (numpy or tensors; they
    go to the device of the params) at positions 0 .. S-1.  A vision
    model's ``patches`` (B, P, d) go first, at positions 0 .. P-1, and the
    tokens follow at P .. P+S-1 (the caches hold P + S).  An
    encoder-decoder's ``frames`` (B, S_enc, d) run the encoder once, and
    the step returns ``(last_logits, caches, enc_kvs)``, each decoder
    layer's cross K/V for ``make_serve_step``.  The caches
    (``init_caches``) are updated as ``stack_apply`` says, under
    ``stack_mode`` (the encoder-decoder's stacks too, as the reference
    passes it).

    ``mesh`` runs the step sharded, as the reference's step compiled over a
    mesh (``make_train_step``'s ``mesh``: a ``DeviceMesh`` of (``pod``,)
    (``data``,) ``model``, each rank calling the step with its own part, or
    a ``launch.input_specs.MeshShape`` for rank 0 on ``meta``): the weights
    by ``param_specs(params, tp)`` (Megatron tensor parallelism over
    ``model``, the vocabulary-parallel embedding and head), the batch's
    rows over the data axes, each cache by ``cache_specs`` (the KV heads
    over ``model`` where they divide, else the head dim, else whole; with
    ``shard_seq``, at batch 1, the sequence over the data axes, as
    ``cache_specs(shard_seq_on_data=True)``), and the caches stay so between
    steps (``nn.attention``).  The logits returned are the rank's (B, V /
    tp) slice of the vocabulary.  The dense family only; another raises
    ``NotImplementedError``.  The step carries ``comm`` (the mesh's
    ``Comm``, or None), whose ``counts`` add up the bytes it sends.
    A sharded prefill starts at position 0, as the reference's does.
    """
    check_stack_mode(stack_mode)
    comm = _serve_comm(cfg, mesh, shard_seq)

    @torch.no_grad()
    def prefill_step(params, batch, caches):
        device = params_device(params)
        inputs = model_batch(cfg, batch, as_device_tensor(batch["tokens"], device), device)
        if comm is not None:
            logits, _, caches = model_apply(_tp_layout(comm, params, None, None), cfg, inputs, caches=caches,
                                            stack_mode=stack_mode, tp=comm)
            # a copy, so that the whole sequence's logits are freed on return
            return logits[:, -1].clone(), caches
        if cfg.is_encoder_decoder:
            enc_out = encdec.encode(params, cfg, inputs["frames"], stack_mode=stack_mode)
            enc_kvs = encdec.encoder_cross_kvs(params, cfg, enc_out)
            logits, _, caches = encdec.decode(params, cfg, inputs["tokens"], enc_kvs, caches=caches,
                                              stack_mode=stack_mode)
            return logits[:, -1], caches, enc_kvs
        logits, _, caches = model_apply(params, cfg, inputs, caches=caches, stack_mode=stack_mode)
        return logits[:, -1], caches

    prefill_step.comm = comm
    return prefill_step


def make_serve_step(cfg, *, stack_mode: str = "unroll", mesh=None, shard_seq: bool = False):
    """Single-token decode against a cache.

    ``(params, token (B, 1), pos, caches, enc_kvs=None, peft=None) ->
    (logits (B, V), next_token (B, 1) int32, caches)``; an
    encoder-decoder's ``enc_kvs`` are its prefill's (each decoder layer's
    cross K/V; without them the decoder skips cross-attention, as the
    reference's does).  ``pos`` is a scalar (an int or a
    0-d tensor: every row at one depth, the caches of ``init_caches``, as
    ``generate`` drives them) or ``(B,)`` (the batched serving cache, where
    every row decodes at its own position); ``peft`` is a tree of
    per-projection :class:`~repro_torch.nn.linear.AdapterPool` nodes (or
    plain LoRA).  The caches are updated as ``stack_apply`` says, under
    ``stack_mode`` as in ``make_prefill_step``.

    ``mesh`` and ``shard_seq`` run the step sharded, as
    ``make_prefill_step``'s; ``next_token`` is then the first index of the
    global maximum, the same on every ``model`` rank
    (``losses.vocab_parallel_argmax``); ``peft`` (pools or plain LoRA,
    replicated, a pool's ``idx`` the rank's rows) is cut as the
    projections are (``nn.linear``)."""
    check_stack_mode(stack_mode)
    comm = _serve_comm(cfg, mesh, shard_seq)

    @torch.no_grad()
    def serve_step(params, token, pos, caches, enc_kvs=None, peft=None):
        if isinstance(pos, torch.Tensor) and pos.ndim == 1:
            positions = pos[:, None] if comm is None else comm.rows(pos, token.shape[0])[:, None]  # (B, 1)
        else:
            positions = torch.full((1,), int(pos), dtype=torch.int64, device=token.device)
        if cfg.is_encoder_decoder:
            logits, _, caches = encdec.decode(params, cfg, token, enc_kvs, positions=positions, caches=caches,
                                              peft=peft, stack_mode=stack_mode)
        else:
            if comm is not None:
                params = _tp_layout(comm, params, None, None)
            logits, _, caches = model_apply(params, cfg, {"tokens": token}, positions=positions, caches=caches,
                                            peft=peft, stack_mode=stack_mode, tp=comm)
        logits = logits[:, -1]
        pred = torch.argmax(logits, dim=-1) if comm is None else vocab_parallel_argmax(logits, comm)
        return logits, pred[:, None].to(torch.int32), caches

    serve_step.comm = comm
    return serve_step
