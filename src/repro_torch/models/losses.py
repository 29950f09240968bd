"""Losses and metrics, as ``repro.models.losses``."""
from __future__ import annotations

import torch


def _nll(logits, labels, z_loss_coef: float):
    """Per-token ``lse - logit[label]`` in float32, plus ``z_loss_coef ·
    lse²`` (the z-loss) when the coefficient is positive."""
    lse = torch.logsumexp(logits, dim=-1)
    nll = lse - torch.gather(logits, -1, labels[..., None])[..., 0]
    return nll + z_loss_coef * torch.square(lse) if z_loss_coef > 0.0 else nll


def softmax_xent(logits, labels, mask=None, z_loss_coef: float = 0.0):
    """Token-level cross entropy in float32, with the reference's optional
    z-loss (``nll += z_loss_coef · lse²``).

    logits: (..., V); labels: (...) integer; mask: (...) {0, 1} or None.
    Returns (mean loss, {"loss", "accuracy", "tokens"}), all 0-d float32
    tensors on the logits' device (no host sync).
    """
    logits = logits.float()
    labels = labels.long()
    nll = _nll(logits, labels, z_loss_coef)
    mask = torch.ones_like(nll) if mask is None else mask.float()
    denom = torch.clamp(torch.sum(mask), min=1.0)
    loss = torch.sum(nll * mask) / denom
    acc = torch.sum((torch.argmax(logits, dim=-1) == labels).float() * mask) / denom
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
