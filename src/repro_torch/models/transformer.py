"""The decoders of the port (dense, and the ``ssm`` family of RWKV6): init,
dense decode caches and the forward pass.

The layer stack keeps the stacked ``(L, ...)`` layout of the JAX package;
``stack_apply`` loops over the layers in Python (the JAX ``unroll`` mode).
STLD gates (``drops``) are host-side booleans: a dropped layer is skipped
by a Python branch, so it launches no kernel and saves no activation.
"""
from __future__ import annotations

import torch

from repro_torch.models import stacking
from repro_torch.models.layers import init_layer_cache, layer_apply, layer_kind, params_kind
from repro_torch.nn.initializers import normal_init, truncated_lecun
from repro_torch.nn.norms import apply_rmsnorm
from repro_torch.nn.rwkv import init_rwkv_channel_mix, init_rwkv_time_mix


def _init_rwkv_layers(cfg, generator: torch.Generator):
    """The stacked ``(L, ...)`` layers of an ``ssm`` (RWKV6) stack."""
    device, lead = generator.device, (cfg.num_layers,)
    return {
        "norm1": {"scale": torch.ones((*lead, cfg.d_model), device=device)},
        "norm2": {"scale": torch.ones((*lead, cfg.d_model), device=device)},
        "time_mix": init_rwkv_time_mix(cfg, generator, lead),
        "channel_mix": init_rwkv_channel_mix(cfg, generator, lead),
    }


def _init_attn_layers(cfg, generator: torch.Generator):
    """The stacked ``(L, ...)`` layers of a dense decoder."""
    d, hd, L = cfg.d_model, cfg.resolved_head_dim, cfg.num_layers
    h, kv, ff = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff
    device = generator.device

    def proj(d_in, d_out):
        return {"w": truncated_lecun(generator, (L, d_in, d_out), fan_in_axis=1)}

    def norm(dim):
        return {"scale": torch.ones((L, dim), device=device)}

    attn = {"wq": proj(d, h * hd), "wk": proj(d, kv * hd), "wv": proj(d, kv * hd), "wo": proj(h * hd, d)}
    if cfg.attention_bias:
        for name, width in (("wq", h * hd), ("wk", kv * hd), ("wv", kv * hd)):
            attn[name]["b"] = torch.zeros((L, width), device=device)
    if cfg.qk_norm:
        attn["q_norm"] = norm(hd)
        attn["k_norm"] = norm(hd)
    return {
        "norm1": norm(d),
        "norm2": norm(d),
        "attn": attn,
        "mlp": {"gate": proj(d, ff), "up": proj(d, ff), "down": proj(ff, d)},
    }


def init_lm(cfg, generator: torch.Generator):
    """Parameters with the shapes and dtypes of ``transformer.init_lm``
    (stacked layout, float32), drawn on the generator's device."""
    init_layers = _init_rwkv_layers if layer_kind(cfg, 0) == "rwkv" else _init_attn_layers
    params = {
        "embed": normal_init(generator, (cfg.vocab_size, cfg.d_model)),
        "layers": init_layers(cfg, generator),
        "final_norm": {"scale": torch.ones((cfg.d_model,), device=generator.device)},
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal_init(generator, (cfg.d_model, cfg.vocab_size))
    return params


def init_caches(cfg, batch: int, max_len: int, dtype=torch.bfloat16, device=None):
    """Stacked decode caches: ``{"k", "v": (L, B, S, KV, hd), "pos": (L,)}``."""
    one = init_layer_cache(cfg, batch, max_len, dtype, device)
    return {
        name: t.unsqueeze(0).repeat((cfg.num_layers,) + (1,) * t.ndim)
        for name, t in one.items()
    }


def stack_apply(layers, cfg, h, *, positions, causal: bool = True, drops=None, caches=None,
                peft=None, lora_scale: float = 1.0):
    """Run the layer stack.  Returns (h, new_caches).

    ``drops``: None or L host-side gates (a CPU bool tensor or a sequence),
    True = the layer is dropped and passes ``h`` (and its cache) through.
    """
    num_layers = stacking.stack_size(layers)
    if caches is not None and params_kind(layers) == "rwkv":
        raise NotImplementedError("RWKV decode states are not ported: the port trains RWKV without caches")
    gates = [False] * num_layers if drops is None else [bool(d) for d in torch.as_tensor(drops).tolist()]
    if len(gates) != num_layers:
        raise ValueError(f"{len(gates)} gates for {num_layers} layers")
    new_pos = []
    for l in range(num_layers):
        cache_l = stacking.layer_view(caches, l) if caches is not None else None
        if not gates[l]:
            h, cache_l = layer_apply(
                stacking.layer_view(layers, l), cfg, h, positions=positions, causal=causal,
                cache=cache_l, peft=stacking.layer_view(peft, l) if peft is not None else None,
                lora_scale=lora_scale,
            )
        if caches is not None:
            new_pos.append(cache_l["pos"])
    new_caches = None
    if caches is not None:
        new_caches = {"k": caches["k"], "v": caches["v"], "pos": torch.stack(new_pos)}
    return h, new_caches


def lm_apply(params, cfg, tokens, *, positions=None, drops=None, caches=None, peft=None,
             lora_scale: float = 1.0):
    """Decoder-only LM forward.  tokens: (B, S) int.  Returns (logits,
    new_caches); the caches' K/V tensors are updated in place."""
    compute_dtype = getattr(torch, cfg.dtype)
    h = params["embed"][tokens].to(compute_dtype)
    if positions is None:
        positions = torch.arange(h.shape[1], device=h.device)
    h, new_caches = stack_apply(
        params["layers"], cfg, h, positions=positions, causal=True, drops=drops, caches=caches,
        peft=peft, lora_scale=lora_scale,
    )
    h = apply_rmsnorm(params["final_norm"], h, cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return h @ head.to(compute_dtype), new_caches
