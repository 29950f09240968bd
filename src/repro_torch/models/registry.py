"""Model registry of the port: the reference's ten archs, in the
``dense``, ``ssm`` (RWKV6), ``hybrid`` (jamba), ``moe`` (granite-moe,
llama4-scout), ``vlm`` (internvl2's decoder behind a patch prefix) and
``audio`` (whisper's encoder-decoder) families.

``init_params(cfg, generator)`` -> parameter tree;
``model_apply(params, cfg, batch, **kw)`` -> (logits, aux, caches), with
``aux`` the router loss summed over the active MoE layers (0.0 without
MoE), as in ``repro.models.registry``.  ``batch`` by modality:

* text: ``{"tokens": (B, S)}``;
* vision: ``{"tokens": (B, S), "patches": (B, P, d)}`` (stub frontend;
  the logits cover the P prefix positions too);
* audio: ``{"tokens": (B, S_dec), "frames": (B, S_enc, d)}`` (stub
  frontend).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import encdec, stacking, transformer

FAMILIES = ("dense", "ssm", "hybrid", "moe", "vlm", "audio")


def _check_family(cfg):
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"the port runs the {FAMILIES} families, not {cfg.family!r}")


def build_model(cfg):
    """``(init_params, model_apply)`` for the architecture family, as the
    reference's ``build_model``."""
    _check_family(cfg)
    return init_params, model_apply


def default_stack_mode(cfg) -> str:
    """The training ``stack_mode`` of the reference's federated engine for
    ``cfg``'s family: ``group`` for a hybrid stack, ``scan`` otherwise (each
    runs the port's one layer loop, and raises where the reference's
    does)."""
    return "group" if cfg.family == "hybrid" else "scan"


def init_params(cfg, generator: torch.Generator, layout: str = "auto", place: bool = False):
    """Random parameters for ``cfg``, drawn from ``generator`` on its device,
    the layer stacks in the reference's ``layout`` (``auto``, ``stacked``
    or ``list``; the same draws in each).

    With ``place``, each part is placed as soon as it is drawn, giving
    ``place_params(init_params(cfg, generator), cfg, generator.device)``
    while holding at most one layer's float32 draws (a hybrid or ``moe``
    stack), one stacked projection's (a dense stack) or one top-level
    entry's (an RWKV6 stack)."""
    _check_family(cfg)
    init = encdec.init_encdec if cfg.is_encoder_decoder else transformer.init_lm
    if not place:
        return init(cfg, generator, layout)
    dtype = getattr(torch, cfg.dtype)
    return init(cfg, generator, layout,
                place=lambda name, tree: _cast_matmul_weights({name: tree}, dtype, generator.device)[name])


# the leaves cast to the compute dtype; whisper's learned positions too
# (the reference casts the table before it indexes it: the same bits)
_MATMUL_WEIGHTS = ("w", "b", "embed", "lm_head", "pos_embed")


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
    kept, and the tree takes no gradient (the base is frozen).  An
    encoder-decoder's encoder and decoder are cast alike, its LayerNorms'
    ``scale`` and ``bias`` kept float32."""
    device = torch.device("cuda" if device is None else device)
    return _cast_matmul_weights(params, getattr(torch, cfg.dtype), device)


class _MetaGenerator(torch.Generator):
    """A CPU generator whose draws land on the ``meta`` device: the init
    functions place every tensor on ``generator.device``, so they build the
    tree's shapes and dtypes without allocating or drawing anything."""

    @property
    def device(self):
        return torch.device("meta")


def param_shapes(cfg, layout: str = "auto"):
    """The tree of ``init_params(cfg, ..., layout)`` on the ``meta``
    device: every leaf's shape and dtype at no memory, at any width (the
    sharding specs read them)."""
    return init_params(cfg, _MetaGenerator(), layout)


def peft_shapes(cfg, peft_cfg):
    """The tree of ``core.peft.init_peft(cfg, peft_cfg, ...)`` on the
    ``meta`` device."""
    from repro_torch.core.peft import init_peft

    return init_peft(cfg, peft_cfg, _MetaGenerator())


def params_device(params) -> torch.device:
    """The device that a parameter tree's leaves lie on."""
    return stacking.tree_leaves(params)[0].device


def _frontend(cfg, batch, devices: Optional[int]):
    """``batch[cfg.frontend_key]`` (frames or patches), a cohort's (N, B,
    ...) folded to (N * B, ...)."""
    x = batch[cfg.frontend_key]
    return x.reshape(-1, *x.shape[-2:]) if devices is not None else x


def model_apply(params, cfg, batch, *, drops=None, caches=None, enc_kvs=None, positions=None, peft=None,
                lora_scale: float = 1.0, devices: Optional[int] = None, stack_mode: str = "unroll",
                active_idx=None, remat: bool = False, tp=None):
    """``devices`` N: a cohort, ``batch["tokens"]`` (N, B, S) (frames or
    patches (N, B, ...)), drops (N, L), the PEFT tree a per-layer list of
    (N, ...) leaves (``lm_apply``).  ``stack_mode`` is one of the
    reference's ``unroll``, ``scan``, ``group`` and ``gather`` (with
    ``active_idx``), all on the Python layer loop
    (``transformer.stack_apply``).

    An encoder-decoder runs the encoder on ``batch["frames"]`` and the
    decoder over its cross K/V (or over ``enc_kvs`` when given, skipping
    the encoder).  As the reference's registry maps every ``stack_mode``
    but ``unroll`` and ``scan`` to ``unroll`` there and drops
    ``active_idx``, a ``gather`` call (whose caller passes no gates) runs
    every decoder layer.  ``remat`` (per-layer recomputation,
    ``stack_apply``) reaches the decoder-only stacks; an encoder-decoder
    takes it and runs without it, as the reference's registry never passes
    it to ``encdec.decode``.

    ``tp`` (a ``sharding.collectives.Comm``) runs one rank's part of the
    tensor-parallel forward of a ``dense`` model (``transformer.lm_apply``:
    the logits are the rank's slice of the vocabulary); another family
    raises ``NotImplementedError``."""
    _check_family(cfg)
    if tp is not None and cfg.family != "dense":
        raise NotImplementedError(f"the tensor-parallel step runs the dense family, not {cfg.family!r}")
    if cfg.is_encoder_decoder:
        if stack_mode in transformer.GATHER_MODES:
            drops = None
        stack_mode = stack_mode if stack_mode in ("unroll", "scan") else "unroll"
        if enc_kvs is None:
            enc_out = encdec.encode(params, cfg, _frontend(cfg, batch, devices), stack_mode=stack_mode)
            enc_kvs = encdec.encoder_cross_kvs(params, cfg, enc_out)
        return encdec.decode(params, cfg, batch["tokens"], enc_kvs, positions=positions, drops=drops, caches=caches,
                             peft=peft, lora_scale=lora_scale, devices=devices, stack_mode=stack_mode)
    prefix = _frontend(cfg, batch, devices) if cfg.prefix_len and cfg.frontend_key in batch else None
    return transformer.lm_apply(
        params, cfg, batch["tokens"], positions=positions, prefix_embeds=prefix, drops=drops, caches=caches,
        peft=peft, lora_scale=lora_scale, devices=devices, stack_mode=stack_mode, active_idx=active_idx,
        remat=remat, tp=tp,
    )
