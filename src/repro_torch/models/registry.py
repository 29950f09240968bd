"""Model registry of the port: the ``dense``, ``ssm`` (RWKV6), ``hybrid``
(jamba) and ``moe`` (granite-moe, llama4-scout) families.

``init_params(cfg, generator)`` -> parameter tree;
``model_apply(params, cfg, batch, **kw)`` -> (logits, aux, caches), with
``batch = {"tokens": (B, S)}`` and ``aux`` the router loss summed over the
active MoE layers (0.0 without MoE), as in ``repro.models.registry``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import transformer

FAMILIES = ("dense", "ssm", "hybrid", "moe")


def _check_family(cfg):
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"the port runs the {FAMILIES} families, not {cfg.family!r}")


def init_params(cfg, generator: torch.Generator, place: bool = False):
    """Random parameters for ``cfg``, drawn from ``generator`` on its device.

    With ``place``, each part is placed as soon as it is drawn, giving
    ``place_params(init_params(cfg, generator), cfg, generator.device)``
    while holding at most one layer's float32 draws (a hybrid or ``moe``
    stack), one stacked projection's (a dense stack) or one top-level
    entry's (an RWKV6 stack)."""
    _check_family(cfg)
    if not place:
        return transformer.init_lm(cfg, generator)
    dtype = getattr(torch, cfg.dtype)
    return transformer.init_lm(
        cfg, generator, place=lambda name, tree: _cast_matmul_weights({name: tree}, dtype, generator.device)[name]
    )


_MATMUL_WEIGHTS = ("w", "b", "embed", "lm_head")


def _cast_matmul_weights(tree, dtype, device):
    if isinstance(tree, (list, tuple)):
        return [_cast_matmul_weights(layer, dtype, device) for layer in tree]
    out = {}
    for key, value in tree.items():
        if isinstance(value, (dict, list, tuple)):
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
    them.  In a hybrid layer the projections' ``w`` and ``b`` (Mamba
    ``in_proj``, ``x_proj``, ``dt_proj``, ``out_proj``; the router and the
    experts) are cast; ``A_log`` and ``D`` stay float32 and the conv
    weights are cast at the point of use.  A ``moe`` layer's attention,
    router, experts and shared expert are cast.  The float32 masters are not
    kept, and the tree takes no gradient (the base is frozen)."""
    device = torch.device("cuda" if device is None else device)
    return _cast_matmul_weights(params, getattr(torch, cfg.dtype), device)


def model_apply(params, cfg, batch, *, drops=None, caches=None, positions=None, peft=None,
                lora_scale: float = 1.0, devices: Optional[int] = None, stack_mode: str = "unroll",
                active_idx=None):
    """``devices`` N: a cohort, ``batch["tokens"]`` (N, B, S), drops (N, L),
    the PEFT tree a per-layer list of (N, ...) leaves (``lm_apply``).
    ``stack_mode`` is one of the reference's ``unroll``, ``scan``,
    ``group`` and ``gather`` (with ``active_idx``), all on the Python layer
    loop (``transformer.stack_apply``)."""
    _check_family(cfg)
    return transformer.lm_apply(
        params, cfg, batch["tokens"], positions=positions, drops=drops, caches=caches, peft=peft,
        lora_scale=lora_scale, devices=devices, stack_mode=stack_mode, active_idx=active_idx,
    )
