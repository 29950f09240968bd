"""One client's local fine-tuning with STLD (paper §3.1-3.2), as
``repro.federated.client``.

``make_client_fns`` returns:

* ``local_round`` — a Python loop over the local mini-batch steps; each
  step draws fresh STLD gates (Bernoulli per layer, on the host), computes
  PEFT-only gradients, accumulates the Eq.-6 PTLS importance statistics,
  clips, and AdamW-updates the PEFT tree.
* ``evaluate`` — full-model (no dropout) classification accuracy.

The batched cohort programs (``cohort_round``, ``cohort_evaluate``,
``cohort_round_eval``) and gather-mode STLD are not ported yet.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core import peft as peft_lib
from repro_torch.core import ptls, stld
from repro_torch.core.schedules import unit_shape
from repro_torch.launch.steps import as_device_tensor, value_and_grad
from repro_torch.models.losses import softmax_xent
from repro_torch.models.registry import model_apply
from repro_torch.optim import adamw_update, clip_by_global_norm, make_lr_schedule


class ClientFns(NamedTuple):
    local_round: Callable
    evaluate: Callable


def make_client_fns(cfg, peft_cfg, stld_cfg, train_cfg, *, device=None, shape=None) -> ClientFns:
    """Build one client's round programs; their tensors live on ``device``
    (None = the card).

    ``shape`` is the (L,) per-layer rate shape (mean 1.0, unclipped) that a
    round scales by its mean rate.  None takes ``unit_shape`` of
    ``stld_cfg.distribution`` with a torch generator seeded 0, never the
    global generator, so two builds give the same rates.  For ``normal``
    that noise is not the reference's ``PRNGKey(0)`` draw: pass the JAX
    package's ``unit_shape("normal", L)`` to get its rates.

    ``local_round(base_params, peft_params, opt_state, batches, mean_rate,
    rng, global_step) -> (peft_params, opt_state, metrics, importance)``:
    ``batches`` holds ``tokens``, ``targets`` and ``mask`` with a leading
    ``(steps,)`` axis; ``rng`` is a CPU ``torch.Generator``, drawn from
    once per step for the gates; ``opt_state`` is the round's AdamW state
    (a fresh ``adamw_init(peft_params)`` each round, as the reference's
    cohort round makes it); ``global_step`` offsets the LR schedule.
    ``metrics`` are the step means of loss, accuracy, grad_norm and
    active_layers; ``importance`` is the (L,) Eq.-6 importance.

    ``evaluate(base_params, peft_params, tokens, labels, num_classes_arr)
    -> accuracy``: argmax over the label-token logits at the final position.
    """
    if stld_cfg.mode != "cond":
        raise NotImplementedError(f"STLD mode {stld_cfg.mode!r} is not ported; the port runs 'cond'")
    device = torch.device("cuda" if device is None else device)
    num_layers = cfg.num_layers
    lora_sc = peft_lib.lora_scale(peft_cfg)
    sched = make_lr_schedule(train_cfg.schedule, train_cfg.learning_rate, train_cfg.warmup_steps,
                             train_cfg.total_steps)
    if shape is None:
        shape = unit_shape(stld_cfg.distribution, num_layers, generator=torch.Generator().manual_seed(0))
    shape = torch.as_tensor(shape, dtype=torch.float32)

    def loss_fn(peft_params, base_params, tokens, targets, mask, drops):
        logits, aux, _ = model_apply(base_params, cfg, {"tokens": tokens}, drops=drops, peft=peft_params,
                                     lora_scale=lora_sc)
        loss, metrics = softmax_xent(logits, targets, mask)
        return loss + cfg.router_aux_coef * aux, metrics  # the metrics' loss stays the cross-entropy

    grad_fn = value_and_grad(loss_fn)

    def local_round(base_params, peft_params, opt_state, batches, mean_rate, rng, global_step):
        rates = torch.clamp(shape * mean_rate, 0.0, 0.95)
        if not stld_cfg.enabled:
            rates = torch.zeros((num_layers,))
        imp = ptls.ImportanceAccumulator.init(num_layers, device)
        tokens, targets, mask = (as_device_tensor(batches[k], device) for k in ("tokens", "targets", "mask"))
        steps = []
        for i in range(tokens.shape[0]):
            drops = stld.sample_drops(rng, rates, stld_cfg.min_active_layers)
            (_, metrics), grads = grad_fn(peft_params, base_params, tokens[i], targets[i], mask[i], drops)
            imp = ptls.ImportanceAccumulator.update(imp, ptls.layer_grad_norms(grads), drops)
            grads, gnorm = clip_by_global_norm(grads, train_cfg.grad_clip)
            peft_params, opt_state = adamw_update(
                grads, opt_state, peft_params, lr=sched(global_step + i), beta1=train_cfg.beta1,
                beta2=train_cfg.beta2, eps=train_cfg.eps, weight_decay=train_cfg.weight_decay,
            )
            steps.append(torch.stack([
                metrics["loss"], metrics["accuracy"], gnorm,
                torch.tensor(float(num_layers - int(drops.sum())), device=device),
            ]))
        means = torch.stack(steps).mean(dim=0)
        metrics = dict(zip(("loss", "accuracy", "grad_norm", "active_layers"), means.unbind()))
        return peft_params, opt_state, metrics, ptls.ImportanceAccumulator.importance(imp)

    @torch.no_grad()
    def evaluate(base_params, peft_params, tokens, labels, num_classes_arr):
        tokens, labels = as_device_tensor(tokens, device), as_device_tensor(labels, device)
        logits, _, _ = model_apply(base_params, cfg, {"tokens": tokens}, peft=peft_params, lora_scale=lora_sc)
        class_logits = logits[:, -1].float()[:, 1 : 1 + len(num_classes_arr)]
        pred = torch.argmax(class_logits, dim=-1)
        return torch.mean((pred == labels.long()).float())

    return ClientFns(local_round, evaluate)
