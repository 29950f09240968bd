"""One client's local fine-tuning with STLD (paper §3.1-3.2), as
``repro.federated.client``.

``make_client_fns`` returns:

* ``local_round`` — a Python loop over the local mini-batch steps; each
  step draws fresh STLD gates on the host (Bernoulli per layer, or in
  gather mode the indices of a fixed count of active layers), computes
  PEFT-only gradients, accumulates the Eq.-6 PTLS importance statistics,
  clips, and AdamW-updates the PEFT tree.
* ``evaluate`` — full-model (no dropout) classification accuracy.
* ``cohort_round`` — the batched cohort: one call trains N devices'
  local rounds together, each from a fresh AdamW state, with its own
  gates, LR offset, clip norm, Eq.-6 importances and metrics.  The
  reference vmaps ``local_round``; the port carries the device axis
  explicitly: the devices fold into the batch, each layer runs once a step
  on the devices whose gate is open, every LoRA projection is one grouped
  ``lora_matmul`` launch, and the backward runs on the sum of the N
  per-device losses (the adapters are independent and the base frozen, so
  each device's gradient is its own).
* ``cohort_evaluate`` — every device's accuracy from validation rows padded
  to one size, with a ``valid`` row mask.
* ``cohort_round_eval`` — ``cohort_round`` then ``cohort_evaluate`` of the
  trained adapters, in one call.

An audio or vision model takes its stub frontend's zero frames or patches
with every batch (``steps.frontend_batch``), and a vision model's patch-prefix
logits are stripped before the loss and the accuracy, as the reference's
client does.  The encoder of an encoder-decoder runs again at every step.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core import peft as peft_lib
from repro_torch.core import ptls, stld
from repro_torch.core.schedules import unit_shape
from repro_torch.launch.steps import as_device_tensor, frontend_batch, token_logits, value_and_grad
from repro_torch.models.losses import cohort_softmax_xent, softmax_xent
from repro_torch.models.registry import model_apply
from repro_torch.models.stacking import from_layer_list, is_stacked, layer_list
from repro_torch.models.transformer import check_stack_mode
from repro_torch.optim import adamw_init, adamw_update, clip_by_global_norm, make_lr_schedule

METRICS = ("loss", "accuracy", "grad_norm", "active_layers")


class ClientFns(NamedTuple):
    local_round: Callable
    evaluate: Callable
    cohort_round: Callable
    cohort_evaluate: Callable
    cohort_round_eval: Callable


def make_client_fns(cfg, peft_cfg, stld_cfg, train_cfg, *, stack_mode: str = "unroll", device=None,
                    shape=None) -> ClientFns:
    """Build one client's round programs; their tensors live on ``device``
    (None = the card).

    ``stack_mode`` (``check_stack_mode``) is every step's, as the
    reference's: a step with gather-mode indices runs ``gather`` instead.
    Each mode runs the one layer loop, and a step raises ``ValueError``
    where the reference's raises (``scan`` of a hybrid stack, ``group``
    off the layer period).

    ``shape`` is the (L,) per-layer rate shape (mean 1.0, unclipped) that a
    round scales by its mean rate.  None takes ``unit_shape`` of
    ``stld_cfg.distribution`` with a torch generator seeded 0, never the
    global generator, so two builds give the same rates.  For ``normal``
    that noise is not the reference's ``PRNGKey(0)`` draw: pass the JAX
    package's ``unit_shape("normal", L)`` to get its rates.

    ``local_round(base_params, peft_params, opt_state, batches, mean_rate,
    rng, global_step, num_active=None) -> (peft_params, opt_state, metrics,
    importance)``:
    ``batches`` holds ``tokens``, ``targets`` and ``mask`` with a leading
    ``(steps,)`` axis; ``rng`` is a CPU ``torch.Generator``, drawn from
    once per step for the gates (in gather mode with ``num_active`` k, for
    the k active layers' indices: the step's drops are their complement,
    and its ``active_layers`` is k); ``opt_state`` is the round's AdamW state
    (a fresh ``adamw_init(peft_params)`` each round, as the reference's
    cohort round makes it); ``global_step`` offsets the LR schedule.
    ``metrics`` are the step means of loss, accuracy, grad_norm and
    active_layers; ``importance`` is the (L,) Eq.-6 importance.

    ``evaluate(base_params, peft_params, tokens, labels, num_classes_arr)
    -> accuracy``: argmax over the label-token logits at the final position.

    ``cohort_round(base_params, peft_stack, batch_stack, rates, rngs,
    global_steps, num_active=None) -> (peft_stack, metrics, importances)``: ``peft_stack``
    is N devices' trees stacked on a leading device axis (stacked layout:
    ``(N, L, ...)`` leaves; list layout: a per-layer list of ``(N, ...)``
    leaves), ``batch_stack`` has ``(N, steps, ...)`` arrays, ``rates``,
    ``rngs`` and ``global_steps`` one entry per device, ``num_active``
    None, one k for all or one per device (gather mode; the reference
    groups a cohort by k, and each device's outputs are the same either
    way).  Before the first step every device draws all of its round's
    gates (or indices), device by device and within a device step by step,
    so that the calls into ``stld`` come in the order of N ``local_round``
    calls.
    ``metrics`` are (N,) step means, ``importances`` (N, L); device i's
    outputs are what ``local_round`` gives it alone.

    ``cohort_evaluate(base_params, peft_stack, tokens, labels, valid,
    num_classes_arr) -> (N,) accuracies`` from (N, P, S) tokens padded to
    P rows with the (N, P) ``valid`` mask; ``cohort_round_eval`` takes the
    arguments of both and returns ``(peft_stack, metrics, importances,
    accuracies)``.
    """
    if stld_cfg.mode not in ("cond", "gather"):
        raise ValueError(f"STLD mode must be 'cond' or 'gather', got {stld_cfg.mode!r}")
    check_stack_mode(stack_mode)
    device = torch.device("cuda" if device is None else device)
    num_layers = cfg.num_layers
    lora_sc = peft_lib.lora_scale(peft_cfg) if peft_cfg.method == "lora" else 1.0
    sched = make_lr_schedule(train_cfg.schedule, train_cfg.learning_rate, train_cfg.warmup_steps,
                             train_cfg.total_steps)
    if shape is None:
        shape = unit_shape(stld_cfg.distribution, num_layers, generator=torch.Generator().manual_seed(0))
    shape = torch.as_tensor(shape, dtype=torch.float32)

    gather_mode = stld_cfg.mode == "gather"

    def loss_fn(peft_params, base_params, tokens, targets, mask, drops, active_idx=None):
        logits, aux, _ = model_apply(base_params, cfg, frontend_batch(cfg, tokens), drops=drops, peft=peft_params,
                                     lora_scale=lora_sc, stack_mode=stack_mode if active_idx is None else "gather",
                                     active_idx=active_idx)
        loss, metrics = softmax_xent(token_logits(cfg, logits, tokens.shape[-1]), targets, mask)
        return loss + cfg.router_aux_coef * aux, metrics  # the metrics' loss stays the cross-entropy

    grad_fn = value_and_grad(loss_fn)

    def round_rates(mean_rate):
        if not stld_cfg.enabled:
            return torch.zeros((num_layers,))
        return torch.clamp(shape * mean_rate, 0.0, 0.95)

    def draw(rng, rates, num_active):
        """One step's (drops, active indices or None): gather mode with a
        static count draws the indices, else the Bernoulli gates."""
        if gather_mode and num_active is not None:
            idx = stld.sample_active_indices(rng, rates, num_active)
            return stld.drops_from_indices(idx, num_layers), idx
        return stld.sample_drops(rng, rates, stld_cfg.min_active_layers), None

    def local_round(base_params, peft_params, opt_state, batches, mean_rate, rng, global_step, num_active=None):
        rates = round_rates(mean_rate)
        imp = ptls.ImportanceAccumulator.init(num_layers, device)
        tokens, targets, mask = (as_device_tensor(batches[k], device) for k in ("tokens", "targets", "mask"))
        steps = []
        for i in range(tokens.shape[0]):
            drops, idx = draw(rng, rates, num_active)
            (_, metrics), grads = grad_fn(peft_params, base_params, tokens[i], targets[i], mask[i], drops, idx)
            imp = ptls.ImportanceAccumulator.update(imp, ptls.layer_grad_norms(grads, num_layers=num_layers), drops)
            grads, gnorm = clip_by_global_norm(grads, train_cfg.grad_clip)
            gnorm = gnorm.to(device)  # on the host for a leafless tree
            peft_params, opt_state = adamw_update(
                grads, opt_state, peft_params, lr=sched(global_step + i), beta1=train_cfg.beta1,
                beta2=train_cfg.beta2, eps=train_cfg.eps, weight_decay=train_cfg.weight_decay,
            )
            steps.append(torch.stack([
                metrics["loss"], metrics["accuracy"], gnorm,
                torch.tensor(float(num_layers - int(drops.sum())), device=device),
            ]))
        means = torch.stack(steps).mean(dim=0)
        metrics = dict(zip(METRICS, means.unbind()))
        return peft_params, opt_state, metrics, ptls.ImportanceAccumulator.importance(imp)

    @torch.no_grad()
    def evaluate(base_params, peft_params, tokens, labels, num_classes_arr):
        tokens, labels = as_device_tensor(tokens, device), as_device_tensor(labels, device)
        logits, _, _ = model_apply(base_params, cfg, frontend_batch(cfg, tokens), peft=peft_params, lora_scale=lora_sc)
        class_logits = logits[:, -1].float()[:, 1 : 1 + len(num_classes_arr)]
        pred = torch.argmax(class_logits, dim=-1)
        return torch.mean((pred == labels.long()).float())

    # ------------------------------------------------------------ the cohort
    def cohort_loss_fn(layers, base_params, tokens, targets, mask, drops, active_idx=None):
        n = tokens.shape[0]
        logits, aux, _ = model_apply(base_params, cfg, frontend_batch(cfg, tokens), drops=drops, peft=layers,
                                     lora_scale=lora_sc, devices=n,
                                     stack_mode=stack_mode if active_idx is None else "gather", active_idx=active_idx)
        logits = token_logits(cfg, logits, tokens.shape[-1])
        loss, metrics = cohort_softmax_xent(logits.view(n, -1, *logits.shape[1:]), targets, mask)
        return torch.sum(loss + cfg.router_aux_coef * aux), metrics

    cohort_grad_fn = value_and_grad(cohort_loss_fn)

    def cohort_train(base_params, layers, batch_stack, rates, rngs, global_steps, num_active=None):
        """The cohort's local rounds on a per-layer list of (N, ...) leaves
        (each layer's adapters a leaf of their own, so a step's gradient
        is written layer by layer, never as a whole stack)."""
        n = len(rngs)
        if num_active is None or isinstance(num_active, int):
            num_active = [num_active] * n
        tokens, targets, mask = (as_device_tensor(batch_stack[k], device) for k in ("tokens", "targets", "mask"))
        steps = tokens.shape[1]
        gates = [[draw(rng, round_rates(float(rate)), k) for _ in range(steps)]
                 for rate, rng, k in zip(rates, rngs, num_active)]
        opt_state = adamw_init(layers)
        imp = ptls.ImportanceAccumulator.init(num_layers, device, devices=n)
        rows = []
        for i in range(steps):
            drops = torch.stack([g[i][0] for g in gates])  # (N, L)
            idx = [g[i][1] for g in gates]
            idx = None if any(x is None for x in idx) else idx
            (_, metrics), grads = cohort_grad_fn(layers, base_params, tokens[:, i], targets[:, i], mask[:, i], drops,
                                                 idx)
            imp = ptls.ImportanceAccumulator.update(imp, ptls.layer_grad_norms(grads, devices=n), drops)
            grads, gnorm = clip_by_global_norm(grads, train_cfg.grad_clip, devices=n)
            gnorm = gnorm.to(device)  # on the host for a leafless tree
            lr = torch.tensor([sched(g + i) for g in global_steps], dtype=torch.float32, device=device)
            layers, opt_state = adamw_update(
                grads, opt_state, layers, lr=lr, beta1=train_cfg.beta1, beta2=train_cfg.beta2, eps=train_cfg.eps,
                weight_decay=train_cfg.weight_decay,
            )
            active = (num_layers - drops.sum(dim=1)).float().to(device)
            rows.append(torch.stack([metrics["loss"], metrics["accuracy"], gnorm, active]))
        means = torch.stack(rows).mean(dim=0)  # (4, N)
        return layers, dict(zip(METRICS, means.unbind())), ptls.ImportanceAccumulator.importance(imp)

    @torch.no_grad()
    def cohort_accuracy(base_params, layers, tokens, labels, valid, num_classes_arr):
        tokens, labels, valid = (as_device_tensor(t, device) for t in (tokens, labels, valid))
        n, rows = labels.shape
        logits, _, _ = model_apply(base_params, cfg, frontend_batch(cfg, tokens), peft=layers, lora_scale=lora_sc,
                                   devices=n)
        class_logits = logits[:, -1].float()[:, 1 : 1 + len(num_classes_arr)].view(n, rows, -1)
        pred = torch.argmax(class_logits, dim=-1)
        correct = (pred == labels.long()).float() * valid.float()
        return torch.sum(correct, dim=1) / torch.clamp(torch.sum(valid.float(), dim=1), min=1.0)

    def cohort_round(base_params, peft_stack, batch_stack, rates, rngs, global_steps, num_active=None):
        layers, metrics, importances = cohort_train(
            base_params, layer_list(peft_stack, num_layers, axis=1), batch_stack, rates, rngs, global_steps,
            num_active)
        return from_layer_list(layers, is_stacked(peft_stack), axis=1), metrics, importances

    def cohort_evaluate(base_params, peft_stack, tokens, labels, valid, num_classes_arr):
        return cohort_accuracy(base_params, layer_list(peft_stack, num_layers, axis=1), tokens, labels, valid,
                               num_classes_arr)

    def cohort_round_eval(base_params, peft_stack, batch_stack, rates, rngs, global_steps, val_tokens, val_labels,
                          val_valid, num_classes_arr, num_active=None):
        layers, metrics, importances = cohort_train(
            base_params, layer_list(peft_stack, num_layers, axis=1), batch_stack, rates, rngs, global_steps,
            num_active)
        accs = cohort_accuracy(base_params, layers, val_tokens, val_labels, val_valid, num_classes_arr)
        return from_layer_list(layers, is_stacked(peft_stack), axis=1), metrics, importances, accs

    return ClientFns(local_round, evaluate, cohort_round, cohort_evaluate, cohort_round_eval)
