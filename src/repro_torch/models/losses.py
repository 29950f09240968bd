"""Losses and metrics, as ``repro.models.losses``."""
from __future__ import annotations

import torch


def _nll(logits, labels, z_loss_coef: float):
    """Per-token ``lse - logit[label]`` in float32, plus ``z_loss_coef ·
    lse²`` (the z-loss) when the coefficient is positive."""
    lse = torch.logsumexp(logits, dim=-1)
    nll = lse - torch.gather(logits, -1, labels[..., None])[..., 0]
    return nll + z_loss_coef * torch.square(lse) if z_loss_coef > 0.0 else nll


@torch.no_grad()
def _max_and_argmax(logits, tp):
    """The global max of logits sharded on the vocabulary (each rank's
    (..., V / tp) slice) and its first index, as ``torch.argmax`` gives it:
    the max over ``model``, then the least index among the ranks that hold
    it (a second ``all_reduce``, of the min)."""
    v_local = logits.shape[-1]
    local_max = torch.amax(logits, dim=-1)
    arg = torch.argmax(logits, dim=-1) + tp.tp_rank * v_local
    m = tp.all_reduce(local_max, "model", "max")
    return m, tp.all_reduce(torch.where(local_max == m, arg, v_local * tp.tp), "model", "min")


def vocab_parallel_argmax(logits, tp):
    """``torch.argmax(logits, -1)`` of logits sharded on the vocabulary
    (this rank's (..., V / tp) slice), the same on every ``model`` rank; the
    logits are compared in float32, as the reference's argmax of bf16
    logits compares their values."""
    return _max_and_argmax(logits.float(), tp)[1]


def _vocab_parallel(logits, labels, z_loss_coef: float, tp):
    """``_nll`` and the argmax of logits sharded on the vocabulary: each
    rank holds its (..., V / tp) slice.  The max over ``model`` (no
    gradient: the log-sum-exp does not depend on it) and the prediction
    (``_max_and_argmax``), then the sums of the exponentials and of the
    target's logit (each from the rank that holds it) in one sum over
    ``model``.  The float32 logits are never whole."""
    v_local = logits.shape[-1]
    local = labels - tp.tp_rank * v_local
    held = (local >= 0) & (local < v_local)
    m, pred = _max_and_argmax(logits, tp)
    target = torch.gather(logits, -1, torch.where(held, local, 0)[..., None])[..., 0]
    sums = tp.reduce(torch.stack([torch.exp(logits - m[..., None]).sum(-1), torch.where(held, target, 0.0)]))
    lse = m + torch.log(sums[0])
    nll = lse - sums[1]
    return (nll + z_loss_coef * torch.square(lse) if z_loss_coef > 0.0 else nll), pred


def softmax_xent(logits, labels, mask=None, z_loss_coef: float = 0.0, *, tp=None):
    """Token-level cross entropy in float32, with the reference's optional
    z-loss (``nll += z_loss_coef · lse²``).

    logits: (..., V); labels: (...) integer; mask: (...) {0, 1} or None.
    Returns (mean loss, {"loss", "accuracy", "tokens"}), all 0-d float32
    tensors on the logits' device (no host sync).

    ``tp`` (a ``sharding.collectives.Comm``): the logits are this rank's
    (..., V / tp) slice of the vocabulary (``transformer.lm_apply``'s
    tensor-parallel head), and the loss and accuracy those of the whole
    vocabulary, the same on every ``model`` rank (``_vocab_parallel``).
    """
    logits = logits.float()
    labels = labels.long()
    if tp is None:
        nll, pred = _nll(logits, labels, z_loss_coef), torch.argmax(logits, dim=-1)
    else:
        nll, pred = _vocab_parallel(logits, labels, z_loss_coef, tp)
    mask = torch.ones_like(nll) if mask is None else mask.float()
    denom = torch.clamp(torch.sum(mask), min=1.0)
    loss = torch.sum(nll * mask) / denom
    acc = torch.sum((pred == labels).float() * mask) / denom
    return loss, {"loss": loss, "accuracy": acc, "tokens": denom}


def cohort_softmax_xent(logits, labels, mask=None, z_loss_coef: float = 0.0):
    """``softmax_xent`` (with its z-loss) of each device of a cohort apart.

    logits: (N, B, S, V); labels: (N, B, S); mask: (N, B, S) or None.
    Returns ((N,) mean losses, {"loss", "accuracy", "tokens"}: (N,) each),
    every device's means over its own tokens and its own mask denominator.
    """
    logits = logits.float()
    labels = labels.long()
    nll = _nll(logits, labels, z_loss_coef)
    mask = torch.ones_like(nll) if mask is None else mask.float()
    dims = tuple(range(1, nll.ndim))
    denom = torch.clamp(torch.sum(mask, dim=dims), min=1.0)
    loss = torch.sum(nll * mask, dim=dims) / denom
    acc = torch.sum((torch.argmax(logits, dim=-1) == labels).float() * mask, dim=dims) / denom
    return loss, {"loss": loss, "accuracy": acc, "tokens": denom}


def lm_shift_labels(tokens):
    """Next-token prediction: inputs ``tokens[:, :-1]``, labels ``tokens[:, 1:]``."""
    return tokens[:, :-1], tokens[:, 1:]
