"""Model registry of the port: the ``dense`` and ``ssm`` (RWKV6) families.

``init_params(cfg, generator)`` -> parameter tree;
``model_apply(params, cfg, batch, **kw)`` -> (logits, aux, caches), with
``batch = {"tokens": (B, S)}`` and ``aux`` the router loss (0.0 for a
dense model), as in ``repro.models.registry``.
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer

FAMILIES = ("dense", "ssm")


def _check_family(cfg):
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"the port runs the {FAMILIES} families, not {cfg.family!r}")


def init_params(cfg, generator: torch.Generator):
    """Random parameters for ``cfg``, drawn from ``generator`` on its device."""
    _check_family(cfg)
    return transformer.init_lm(cfg, generator)


_MATMUL_WEIGHTS = ("w", "b", "embed", "lm_head")


def _cast_matmul_weights(tree, dtype, device):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out[key] = _cast_matmul_weights(value, dtype, device)
        elif key in _MATMUL_WEIGHTS:
            out[key] = value.to(device=device, dtype=dtype)
        else:
            out[key] = value.to(device=device)
    return out


def place_params(params, cfg, device=None):
    """The base params on ``device`` (None = the card), the matmul weights
    (and biases) cast to ``cfg.dtype`` once; norm scales stay float32, as
    the JAX package reads them.  In an RWKV6 layer the projections' ``w``
    (time-mix r/k/v/o, channel-mix k/v/r) are cast; every other leaf stays
    float32: the decay path (``w0``, ``wd_a``, ``wd_b``) and the bonus ``u``
    compute in float32, and the low-rank ``ts_lora_*``, ``wg_*`` and the
    ``mu*`` mixes are cast at the point of use, as the JAX package casts
    them.  The float32 masters are not kept, and the
    tree takes no gradient (the base is frozen)."""
    device = torch.device("cuda" if device is None else device)
    return _cast_matmul_weights(params, getattr(torch, cfg.dtype), device)


def model_apply(params, cfg, batch, *, drops=None, caches=None, positions=None, peft=None,
                lora_scale: float = 1.0):
    _check_family(cfg)
    logits, new_caches = transformer.lm_apply(
        params, cfg, batch["tokens"], positions=positions, drops=drops, caches=caches, peft=peft,
        lora_scale=lora_scale,
    )
    return logits, 0.0, new_caches
