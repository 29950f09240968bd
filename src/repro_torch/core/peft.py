"""LoRA trees (the LoRA branch of ``repro.core.peft``).

A tree is stacked like the layers.  Dense decoder: ``{"attn": {"q": {"a":
(L, d_in, r), "b": (L, r, d_out)}, ...}, "mlp": {...}}`` over
``lora_targets``.  RWKV6 (family ``ssm``): ``{"cm": {"up", "down"}}`` on
the channel-mix in every layer, whatever ``lora_targets`` says, as the JAX
package's rwkv branch does.  ``b`` starts at zero, so a
fresh adapter leaves the base model's outputs unchanged.
"""
from __future__ import annotations

import torch

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


def _lora(generator, L, d_in, d_out, r):
    return {
        "a": truncated_lecun(generator, (L, d_in, r), fan_in_axis=1),
        "b": torch.zeros((L, r, d_out), device=generator.device),
    }


def init_peft(cfg, peft_cfg, generator: torch.Generator):
    """Stacked LoRA tree for every target in ``peft_cfg.lora_targets`` (a
    dense decoder), or for the channel-mix ``up`` and ``down`` (RWKV6)."""
    L, r = cfg.num_layers, peft_cfg.lora_rank
    if cfg.family == "ssm":
        return {"cm": {"up": _lora(generator, L, cfg.d_model, cfg.d_ff, r),
                       "down": _lora(generator, L, cfg.d_ff, cfg.d_model, r)}}
    tree = {}
    for group, dims in (("attn", _ATTN_DIMS), ("mlp", _MLP_DIMS)):
        for t in peft_cfg.lora_targets:
            if t in dims:
                tree.setdefault(group, {})[t] = _lora(generator, L, *dims[t](cfg), r)
    return tree
