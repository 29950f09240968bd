"""The ``attn`` residual block of the dense decoder, and its decode cache."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.nn.attention import attention_apply
from repro_torch.nn.mlp import mlp_apply
from repro_torch.nn.norms import apply_rmsnorm


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
    """Pre-norm attention + SwiGLU MLP.  Returns (h, new_cache)."""
    peft = peft or {}
    out, new_cache = attention_apply(
        params["attn"], cfg, apply_rmsnorm(params["norm1"], h, cfg.norm_eps), positions,
        causal=causal, cache=cache, peft=peft.get("attn"), lora_scale=lora_scale,
    )
    h = h + out
    x = apply_rmsnorm(params["norm2"], h, cfg.norm_eps)
    h = h + mlp_apply(params["mlp"], cfg, x, peft.get("mlp"), lora_scale)
    return h, new_cache
