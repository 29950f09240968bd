"""The residual blocks of the port's decoders, and the dense decode cache.

Layer kinds (``layer_kind(cfg, l)``), as in ``repro.models.layers``:
  * ``attn`` — pre-norm GQA attention + SwiGLU MLP   (dense archs)
  * ``rwkv`` — RWKV6 time-mix + channel-mix           (ssm archs)
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.nn.attention import attention_apply
from repro_torch.nn.mlp import mlp_apply
from repro_torch.nn.norms import apply_rmsnorm
from repro_torch.nn.rwkv import channel_mix_apply, time_mix_apply


def layer_kind(cfg, l: int) -> str:
    return "rwkv" if cfg.family == "ssm" else "attn"


def params_kind(params) -> str:
    """The layer kind, from the layer's parameter structure."""
    return "rwkv" if "time_mix" in params else "attn"


def init_layer_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16, device=None):
    """Decode-time KV ring of one attention layer (``pos`` is a scalar here;
    the serving batcher widens it to one position per row)."""
    hd = cfg.resolved_head_dim
    cache_len = max_len
    if cfg.sliding_window is not None:
        cache_len = min(max_len, cfg.sliding_window)
    shape = (batch, cache_len, cfg.num_kv_heads, hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }


def layer_apply(params, cfg, h, *, positions, causal=True, cache: Optional[dict] = None,
                peft: Optional[dict] = None, lora_scale: float = 1.0):
    """One residual block: pre-norm attention + SwiGLU MLP, or RWKV6
    time-mix + channel-mix (LoRA on the channel-mix ``up`` and ``down``).
    Returns (h, new_cache)."""
    peft = peft or {}
    if params_kind(params) == "rwkv":
        tm_out, tm_state = time_mix_apply(
            params["time_mix"], cfg, apply_rmsnorm(params["norm1"], h, cfg.norm_eps), state=cache
        )
        h = h + tm_out
        cm_out, cm_state = channel_mix_apply(
            params["channel_mix"], cfg, apply_rmsnorm(params["norm2"], h, cfg.norm_eps), state=cache,
            peft=peft.get("cm"), lora_scale=lora_scale,
        )
        h = h + cm_out
        return h, ({**tm_state, **cm_state} if cache is not None else None)
    out, new_cache = attention_apply(
        params["attn"], cfg, apply_rmsnorm(params["norm1"], h, cfg.norm_eps), positions,
        causal=causal, cache=cache, peft=peft.get("attn"), lora_scale=lora_scale,
    )
    h = h + out
    x = apply_rmsnorm(params["norm2"], h, cfg.norm_eps)
    h = h + mlp_apply(params["mlp"], cfg, x, peft.get("mlp"), lora_scale)
    return h, new_cache
