"""LoRA trees (the LoRA branch of ``repro.core.peft``).

A tree is laid out like the layers.  Dense decoder (stacked): ``{"attn":
{"q": {"a": (L, d_in, r), "b": (L, r, d_out)}, ...}, "mlp": {...}}`` over
``lora_targets``.  RWKV6 (family ``ssm``, stacked): ``{"cm": {"up",
"down"}}`` on the channel-mix in every layer, whatever ``lora_targets``
says, as the JAX package's rwkv branch does.  Hybrid (jamba): one tree per
layer, ``{"mamba": {"in", "out"}}`` on a Mamba layer whatever the targets,
the targets' ``{"attn": ...}`` on an attention layer and ``{"mlp": ...}``
on a layer without MoE; the list is stacked only when every layer's tree
has one structure, as ``maybe_stack(..., "auto")`` does.  ``b`` starts at
zero, so a fresh adapter leaves the base model's outputs unchanged.
"""
from __future__ import annotations

import torch

from repro_torch.models import stacking
from repro_torch.models.layers import layer_kind
from repro_torch.nn.initializers import truncated_lecun

_ATTN_DIMS = {
    "q": lambda cfg: (cfg.d_model, cfg.num_heads * cfg.resolved_head_dim),
    "k": lambda cfg: (cfg.d_model, cfg.num_kv_heads * cfg.resolved_head_dim),
    "v": lambda cfg: (cfg.d_model, cfg.num_kv_heads * cfg.resolved_head_dim),
    "o": lambda cfg: (cfg.num_heads * cfg.resolved_head_dim, cfg.d_model),
}
_MLP_DIMS = {
    "gate": lambda cfg: (cfg.d_model, cfg.d_ff),
    "up": lambda cfg: (cfg.d_model, cfg.d_ff),
    "down": lambda cfg: (cfg.d_ff, cfg.d_model),
}


def lora_scale(peft_cfg) -> float:
    return peft_cfg.lora_alpha / peft_cfg.lora_rank


def _lora(generator, lead, d_in, d_out, r):
    return {
        "a": truncated_lecun(generator, (*lead, d_in, r), fan_in_axis=len(lead)),
        "b": torch.zeros((*lead, r, d_out), device=generator.device),
    }


def _targets(cfg, peft_cfg, generator, lead, with_mlp: bool):
    tree = {}
    for group, dims in (("attn", _ATTN_DIMS), ("mlp", _MLP_DIMS)):
        if group == "mlp" and not with_mlp:
            continue
        for t in peft_cfg.lora_targets:
            if t in dims:
                tree.setdefault(group, {})[t] = _lora(generator, lead, *dims[t](cfg), peft_cfg.lora_rank)
    return tree


def _hybrid_layer(cfg, peft_cfg, generator, l: int):
    if layer_kind(cfg, l) == "mamba":
        d_in, r = cfg.mamba.expand * cfg.d_model, peft_cfg.lora_rank
        return {"mamba": {"in": _lora(generator, (), cfg.d_model, 2 * d_in, r),
                          "out": _lora(generator, (), d_in, cfg.d_model, r)}}
    return _targets(cfg, peft_cfg, generator, (), with_mlp=not cfg.is_moe_layer(l))


def init_peft(cfg, peft_cfg, generator: torch.Generator):
    """LoRA tree for every target in ``peft_cfg.lora_targets`` (a dense
    decoder; a hybrid stack's attention and MLP layers, with ``in`` and
    ``out`` on its Mamba layers), or for the channel-mix ``up`` and
    ``down`` (RWKV6)."""
    L, r = cfg.num_layers, peft_cfg.lora_rank
    if cfg.family == "ssm":
        return {"cm": {"up": _lora(generator, (L,), cfg.d_model, cfg.d_ff, r),
                       "down": _lora(generator, (L,), cfg.d_ff, cfg.d_model, r)}}
    if cfg.family == "hybrid":
        return stacking.maybe_stack([_hybrid_layer(cfg, peft_cfg, generator, l) for l in range(L)])
    return _targets(cfg, peft_cfg, generator, (L,), with_mlp=True)
