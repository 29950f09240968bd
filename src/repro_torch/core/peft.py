"""PEFT methods (LoRA, adapter, BitFit, none), as ``repro.core.peft``.

The PEFT tree is laid out like the layers (``models.stacking``): stacked
``(L, ...)`` leaves when every layer's tree has one structure, else a
per-layer list, as ``maybe_stack(..., "auto")`` decides.  A layer's tree:

* ``lora``: on a dense decoder ``{"attn": {"q": {"a": (d_in, r), "b": (r,
  d_out)}, ...}, "mlp": {...}}`` over ``lora_targets``; on RWKV6 (family
  ``ssm``) ``{"cm": {"up", "down"}}`` on the channel-mix whatever the
  targets; on jamba (``hybrid``) ``{"mamba": {"in", "out"}}`` on a Mamba
  layer, the targets' ``attn`` on an attention layer and ``mlp`` on a
  layer without MoE (a list: the layers differ); on the ``moe`` family
  the targets' ``attn`` alone, stacked (no layer has an MLP to adapt); on
  whisper's decoder (``audio``) the targets' ``attn`` and ``mlp`` and the
  attention targets again as ``cross`` on the cross-attention, stacked
  (the encoder takes no PEFT).  ``b`` starts at zero.
* ``adapter``: ``adapter_attn`` on an attention (or ``encdec``) layer and
  ``adapter_mlp`` on every layer, Houlsby bottlenecks of ``adapter_dim`` whose ``up``
  starts at zero (jamba's tree is a list: its Mamba layers have no
  ``adapter_attn``).
* ``bitfit``: float32 zero biases ``bias_attn`` and ``bias_mlp`` of
  ``(d_model,)`` (stacked on every family).
* ``none``: the empty tree (stacked and leafless).

So a fresh tree of any method leaves the base model's outputs unchanged.
Only the PEFT tree trains; the base is frozen (paper §2.2).
"""
from __future__ import annotations

import torch

from repro_torch.models import stacking
from repro_torch.models.layers import layer_kind
from repro_torch.nn.linear import init_lora
from repro_torch.nn.mlp import init_adapter

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


def _targets(cfg, peft_cfg, generator, lead, with_mlp: bool, with_cross: bool = False):
    tree = {}
    for group, dims in (("attn", _ATTN_DIMS), ("mlp", _MLP_DIMS), ("cross", _ATTN_DIMS)):
        if (group == "mlp" and not with_mlp) or (group == "cross" and not with_cross):
            continue
        for t in peft_cfg.lora_targets:
            if t in dims:
                tree.setdefault(group, {})[t] = init_lora(generator, *dims[t](cfg), peft_cfg.lora_rank, lead=lead)
    return tree


def _hybrid_lora_layer(cfg, peft_cfg, generator, l: int):
    if layer_kind(cfg, l) == "mamba":
        d_in, r = cfg.mamba.expand * cfg.d_model, peft_cfg.lora_rank
        return {"mamba": {"in": init_lora(generator, cfg.d_model, 2 * d_in, r),
                          "out": init_lora(generator, d_in, cfg.d_model, r)}}
    return _targets(cfg, peft_cfg, generator, (), with_mlp=not cfg.is_moe_layer(l))


def _init_lora(cfg, peft_cfg, generator):
    L, r = cfg.num_layers, peft_cfg.lora_rank
    if cfg.family == "ssm":
        return {"cm": {"up": init_lora(generator, cfg.d_model, cfg.d_ff, r, lead=(L,)),
                       "down": init_lora(generator, cfg.d_ff, cfg.d_model, r, lead=(L,))}}
    if cfg.family == "hybrid":
        return [_hybrid_lora_layer(cfg, peft_cfg, generator, l) for l in range(L)]
    return _targets(cfg, peft_cfg, generator, (L,), with_mlp=not cfg.is_moe_layer(0),
                    with_cross=layer_kind(cfg, 0) == "encdec")


def init_layer_peft(cfg, peft_cfg, generator, l: int) -> dict:
    """Layer ``l``'s adapter, BitFit or empty tree (float32)."""
    method = peft_cfg.method
    if method == "adapter":
        p = {}
        if layer_kind(cfg, l) in ("attn", "encdec"):
            p["adapter_attn"] = init_adapter(generator, cfg.d_model, peft_cfg.adapter_dim)
        p["adapter_mlp"] = init_adapter(generator, cfg.d_model, peft_cfg.adapter_dim)
        return p
    if method == "bitfit":
        return {"bias_attn": torch.zeros((cfg.d_model,), device=generator.device),
                "bias_mlp": torch.zeros((cfg.d_model,), device=generator.device)}
    if method == "none":
        return {}
    raise ValueError(f"unknown PEFT method {method!r}")


def init_peft(cfg, peft_cfg, generator: torch.Generator, layout: str = "auto"):
    """The PEFT tree of ``peft_cfg.method`` (module docstring), drawn on
    the generator's device, in the reference's ``layout``: ``auto``
    stacks exactly when the reference's stacks, ``stacked`` raises for a
    heterogeneous stack, ``list`` keeps one tree a layer (the same draws
    in every layout)."""
    if peft_cfg.method == "lora":
        tree = _init_lora(cfg, peft_cfg, generator)  # LoRA of a homogeneous stack, drawn stacked
    else:
        tree = [init_layer_peft(cfg, peft_cfg, generator, l) for l in range(cfg.num_layers)]
    return stacking.in_layout(tree, layout, cfg.num_layers)


def count_params(tree) -> int:
    return sum(int(x.numel()) for x in stacking.tree_leaves(tree))


def flat_bytes(tree) -> int:
    return sum(int(x.numel() * x.element_size()) for x in stacking.tree_leaves(tree))


_LORA_TARGET_MAP = {
    "q": ("attn", "wq"),
    "k": ("attn", "wk"),
    "v": ("attn", "wv"),
    "o": ("attn", "wo"),
    "gate": ("mlp", "gate"),
    "up": ("mlp", "up"),
    "down": ("mlp", "down"),
}


def _merge_one(layer, p, scale):
    layer = stacking.tree_map(lambda x: x, layer)  # a copy of the dicts, the tensors shared
    for group in ("attn", "mlp"):
        for t, lora in (p.get(group) or {}).items():
            mod, name = _LORA_TARGET_MAP[t]
            w = layer[mod][name]["w"]
            # a @ b batches over a leading stacked layer axis:
            # (L, d_in, r) @ (L, r, d_out) -> (L, d_in, d_out)
            layer[mod][name]["w"] = w + scale * (lora["a"] @ lora["b"]).to(w.dtype)
    return layer


def merge_lora_into_base(base_layers, peft, scale: float):
    """Fold LoRA deltas into the frozen weights (the deployment path):
    ``W' = W + scale * A @ B`` on the attention and MLP targets.  Either
    layer layout (both trees in the same one); returns the merged stack in
    that layout, the inputs untouched.  A decoder layer's ``cross`` LoRA is
    not merged, as the reference's merge skips it."""
    if stacking.is_stacked(base_layers):
        return _merge_one(base_layers, peft, scale)
    return [_merge_one(layer, p, scale) for layer, p in zip(base_layers, peft)]
