"""The residual blocks of the port's decoders, and each layer's decode cache.

Layer kinds (``layer_kind(cfg, l)``), as in ``repro.models.layers``:
  * ``attn``   — pre-norm GQA attention + (MoE | SwiGLU or GELU MLP)
  * ``mamba``  — pre-norm Mamba block + (MoE | SwiGLU MLP)   (hybrid archs)
  * ``rwkv``   — RWKV6 time-mix + channel-mix                (ssm archs)
  * ``encdec`` — self-attention + cross-attention + MLP      (whisper's decoder)

The whisper encoder's layers are ``attn`` layers with a GELU MLP; every
norm of a GELU config is a LayerNorm (``apply_norm`` reads its ``bias``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.nn.attention import attention_apply, cross_attention_apply, init_attention, init_cross_attention
from repro_torch.nn.mamba import init_mamba, init_mamba_state, mamba_apply
from repro_torch.nn.mlp import adapter_apply, init_mlp, mlp_apply
from repro_torch.nn.moe import init_moe, moe_apply
from repro_torch.nn.norms import apply_norm
from repro_torch.nn.rwkv import (channel_mix_apply, init_rwkv_channel_mix, init_rwkv_state, init_rwkv_time_mix,
                                 time_mix_apply)


def layer_kind(cfg, l: int) -> str:
    if cfg.family == "ssm":
        return "rwkv"
    if cfg.family == "audio":
        return "encdec"
    if cfg.family == "hybrid" and not cfg.is_attention_layer(l):
        return "mamba"
    return "attn"


def params_kind(params) -> str:
    """The layer kind, from the layer's parameter structure."""
    if "time_mix" in params:
        return "rwkv"
    if "mamba" in params:
        return "mamba"
    if "cross" in params:
        return "encdec"
    return "attn"


def model_norm(cfg, generator: torch.Generator, lead=()):
    """A layer's or the final norm: a unit RMSNorm ``scale``, or a
    LayerNorm (with a zero ``bias``) for a GELU config, as the reference's
    ``_norm_pair``; ``lead`` (L,) stacks L of them."""
    p = {"scale": torch.ones((*lead, cfg.d_model), device=generator.device)}
    if cfg.activation == "gelu":
        p["bias"] = torch.zeros((*lead, cfg.d_model), device=generator.device)
    return p


def init_layer(cfg, l: int, generator: torch.Generator, force_kind: Optional[str] = None, *, lead=(), place=None):
    """Parameters of layer ``l`` (float32, on the generator's device), as
    ``repro.models.layers.init_layer``: RWKV6 time-mix and channel-mix, or
    a Mamba or attention mixer (an ``encdec`` layer adds the
    cross-attention and its norm), then MoE or an MLP.  ``force_kind``
    overrides ``layer_kind`` (``"attn"``: whisper's encoder layers).

    ``lead`` (L,) draws L layers of one kind stacked (a homogeneous stack:
    the dense and RWKV6 decoders, whisper's two stacks), each leaf drawn
    whole in turn; ``place(proj)``, when given, takes each attention and
    MLP projection as soon as it is drawn.  An ``encdec`` layer draws its
    cross-attention after the MLP: the port's draw order, which a seed's
    weights depend on."""
    kind = force_kind or layer_kind(cfg, l)
    if lead and (kind == "mamba" or cfg.is_moe_layer(l)):
        raise ValueError("Mamba and MoE layers are drawn one at a time (no lead)")
    p = {"norm1": model_norm(cfg, generator, lead), "norm2": model_norm(cfg, generator, lead)}
    if kind == "rwkv":
        p["time_mix"] = init_rwkv_time_mix(cfg, generator, lead)
        p["channel_mix"] = init_rwkv_channel_mix(cfg, generator, lead)
        return p
    if kind == "mamba":
        p["mamba"] = init_mamba(cfg, generator)
    else:
        p["attn"] = init_attention(cfg, generator, lead=lead, place=place)
    if cfg.is_moe_layer(l):
        p["moe"] = init_moe(cfg, generator)
    else:
        p["mlp"] = init_mlp(cfg, generator, lead=lead, place=place)
    if kind == "encdec":
        p["cross"] = init_cross_attention(cfg, generator, lead=lead)
        p["norm_cross"] = model_norm(cfg, generator, lead)
    return p


def init_layer_cache(cfg, l: int, batch: int, max_len: int, dtype=torch.bfloat16, device=None):
    """Decode-time cache of layer ``l``, as ``repro.models.layers
    .init_layer_cache``: an RWKV6 or Mamba layer's float32 state on
    ``device``, or an attention (or ``encdec``) layer's KV ring of ``min(max_len, window)``
    slots in ``dtype`` with a scalar ``pos``, which stays on the host (the
    serving batcher widens it to one position per row, on the device)."""
    kind = layer_kind(cfg, l)
    if kind == "rwkv":
        return init_rwkv_state(cfg, batch, device)
    if kind == "mamba":
        return init_mamba_state(cfg, batch, device)
    hd = cfg.resolved_head_dim
    cache_len = max_len
    if cfg.sliding_window is not None:
        cache_len = min(max_len, cfg.sliding_window)
    shape = (batch, cache_len, cfg.num_kv_heads, hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.zeros((), dtype=torch.int32),
    }


def _add_bias(out, bias, devices: Optional[int]):
    """``out + bias`` (BitFit); for a cohort (``devices`` N, ``bias`` (N,
    d)) each device's row block of ``out`` takes its own bias."""
    bias = bias.to(out.dtype)
    if devices is None or bias.ndim == 1:
        return out + bias
    return (out.reshape(devices, -1, out.shape[-1]) + bias[:, None]).reshape(out.shape)


def _peft_out(out, peft, devices: Optional[int], *, bias: str, adapter: Optional[str] = None):
    """A mixer's or feed-forward's output through its PEFT branches: the
    adapter ``peft[adapter]``, then the bias ``peft[bias]``, each where the
    tree has it."""
    if adapter in peft:
        out = adapter_apply(peft[adapter], out, devices)
    if bias in peft:
        out = _add_bias(out, peft[bias], devices)
    return out


def layer_apply(params, cfg, h, *, positions, causal=True, cache: Optional[dict] = None,
                enc_kv: Optional[dict] = None, peft: Optional[dict] = None, lora_scale: float = 1.0,
                devices: Optional[int] = None, tp=None):
    """One residual block: RWKV6 time-mix + channel-mix (LoRA on the
    channel-mix ``up`` and ``down``), or a pre-norm mixer (attention, or
    Mamba with LoRA on ``in`` and ``out``) followed by a pre-norm MoE or
    MLP.  An ``encdec`` layer given ``enc_kv`` (its encoder K/V) runs a
    pre-norm cross-attention (``peft["cross"]``'s LoRA on ``q`` and ``o``)
    between the two, as the reference's; without ``enc_kv`` it skips it.
    Returns (h, the MoE aux loss (0.0 without MoE), new_cache).

    The adapter and BitFit branches sit where the reference puts them:
    ``bias_attn`` on the RWKV time-mix and on the Mamba output,
    ``adapter_attn`` then ``bias_attn`` on the attention output, and
    ``adapter_mlp`` then ``bias_mlp`` on the MLP's or MoE's output and on
    the RWKV channel-mix.

    ``devices`` N: ``h`` folds N devices' equal row blocks into its batch
    and every PEFT node holds one adapter or bias per device (``(N, in,
    r)``, ``(N, d)``); the MoE routes each device's tokens apart and its
    aux loss is (N,).

    ``tp`` (a ``sharding.collectives.Comm``) runs this rank's part of a
    tensor-parallel step (``attention_apply``, ``mlp_apply``): an ``attn``
    layer with an MLP, the dense family's; other layers raise
    ``NotImplementedError``."""
    peft = peft or {}
    kind = params_kind(params)
    if tp is not None and (kind != "attn" or "moe" in params):
        raise NotImplementedError(f"the tensor-parallel step runs attention + MLP layers, not {kind!r}"
                                  + (" with MoE" if "moe" in params else ""))
    if kind == "rwkv":
        tm_out, tm_state = time_mix_apply(
            params["time_mix"], cfg, apply_norm(params["norm1"], h, cfg.norm_eps), state=cache
        )
        h = h + _peft_out(tm_out, peft, devices, bias="bias_attn")
        cm_out, cm_state = channel_mix_apply(
            params["channel_mix"], cfg, apply_norm(params["norm2"], h, cfg.norm_eps), state=cache,
            peft=peft.get("cm"), lora_scale=lora_scale,
        )
        h = h + _peft_out(cm_out, peft, devices, adapter="adapter_mlp", bias="bias_mlp")
        return h, 0.0, ({**tm_state, **cm_state} if cache is not None else None)
    x = apply_norm(params["norm1"], h, cfg.norm_eps)
    if kind == "mamba":
        out, state = mamba_apply(params["mamba"], cfg, x, state=cache, peft=peft.get("mamba"), lora_scale=lora_scale)
        new_cache = state if cache is not None else None
        out = _peft_out(out, peft, devices, bias="bias_attn")
    else:
        out, new_cache = attention_apply(params["attn"], cfg, x, positions, causal=causal, cache=cache,
                                         peft=peft.get("attn"), lora_scale=lora_scale, tp=tp)
        out = _peft_out(out, peft, devices, adapter="adapter_attn", bias="bias_attn")
    h = h + out
    if kind == "encdec" and enc_kv is not None:
        h = h + cross_attention_apply(params["cross"], cfg, apply_norm(params["norm_cross"], h, cfg.norm_eps), enc_kv,
                                      peft=peft.get("cross"), lora_scale=lora_scale)
    x = apply_norm(params["norm2"], h, cfg.norm_eps)
    aux = 0.0
    if "moe" in params:
        out, aux = moe_apply(params["moe"], cfg, x, devices=devices)
    else:
        out = mlp_apply(params["mlp"], cfg, x, peft.get("mlp"), lora_scale, tp=tp)
    return h + _peft_out(out, peft, devices, adapter="adapter_mlp", bias="bias_mlp"), aux, new_cache
