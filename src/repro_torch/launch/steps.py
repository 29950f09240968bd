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
from repro_torch.models.losses import softmax_xent
from repro_torch.models import encdec
from repro_torch.models.registry import model_apply, params_device
from repro_torch.models.stacking import tree_leaves, tree_map
from repro_torch.models.transformer import check_stack_mode
from repro_torch.optim import adamw_update, clip_by_global_norm


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


def make_train_step(cfg, peft_cfg, train_cfg, *, stld_mode: str = "off", mean_rate: float = 0.5,
                    distribution: str = "incremental", stack_mode: str = "unroll", shape=None,
                    gather_bucket: int = 4, remat: bool = False):
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
    The reference's ``regather_specs`` (an FSDP all-gather of the base
    params) has no counterpart: the port runs no sharded step.
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

    def loss_fn(peft_params, base_params, inputs, targets, drops, active_idx=None):
        logits, aux, _ = model_apply(base_params, cfg, inputs, drops=drops, peft=peft_params,
                                     lora_scale=lora_sc, stack_mode=stack_mode if active_idx is None else "gather",
                                     active_idx=active_idx, remat=remat)
        loss, metrics = softmax_xent(token_logits(cfg, logits, targets.shape[1]), targets)
        return loss + cfg.router_aux_coef * aux, metrics

    grad_fn = value_and_grad(loss_fn)

    def train_step(base_params, peft_params, opt_state, batch, rng):
        device = params_device(base_params)
        tokens = as_device_tensor(batch["tokens"], device)
        drops = active_idx = None
        if stld_mode == "cond":
            drops = stld.sample_drops(rng, rates, 1)
        elif stld_mode == "gather":
            active_idx = stld.sample_active_indices(rng, rates, num_active)
        (_, metrics), grads = grad_fn(peft_params, base_params, model_batch(cfg, batch, tokens[:, :-1], device),
                                      tokens[:, 1:], drops, active_idx)
        grads, gnorm = clip_by_global_norm(grads, train_cfg.grad_clip)
        peft_params, opt_state = adamw_update(
            grads, opt_state, peft_params, lr=train_cfg.learning_rate, beta1=train_cfg.beta1,
            beta2=train_cfg.beta2, eps=train_cfg.eps, weight_decay=train_cfg.weight_decay,
        )
        return peft_params, opt_state, dict(metrics, grad_norm=gnorm)

    return train_step


def make_prefill_step(cfg, *, stack_mode: str = "unroll"):
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
    passes it)."""
    check_stack_mode(stack_mode)

    @torch.no_grad()
    def prefill_step(params, batch, caches):
        device = params_device(params)
        inputs = model_batch(cfg, batch, as_device_tensor(batch["tokens"], device), device)
        if cfg.is_encoder_decoder:
            enc_out = encdec.encode(params, cfg, inputs["frames"], stack_mode=stack_mode)
            enc_kvs = encdec.encoder_cross_kvs(params, cfg, enc_out)
            logits, _, caches = encdec.decode(params, cfg, inputs["tokens"], enc_kvs, caches=caches,
                                              stack_mode=stack_mode)
            return logits[:, -1], caches, enc_kvs
        logits, _, caches = model_apply(params, cfg, inputs, caches=caches, stack_mode=stack_mode)
        return logits[:, -1], caches

    return prefill_step


def make_serve_step(cfg, *, stack_mode: str = "unroll"):
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
    """
    check_stack_mode(stack_mode)

    @torch.no_grad()
    def serve_step(params, token, pos, caches, enc_kvs=None, peft=None):
        if isinstance(pos, torch.Tensor) and pos.ndim == 1:
            positions = pos[:, None]  # (B, 1)
        else:
            positions = torch.full((1,), int(pos), dtype=torch.int64, device=token.device)
        if cfg.is_encoder_decoder:
            logits, _, caches = encdec.decode(params, cfg, token, enc_kvs, positions=positions, caches=caches,
                                              peft=peft, stack_mode=stack_mode)
        else:
            logits, _, caches = model_apply(params, cfg, {"tokens": token}, positions=positions, caches=caches,
                                            peft=peft, stack_mode=stack_mode)
        logits = logits[:, -1]
        next_token = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        return logits, next_token, caches

    return serve_step
