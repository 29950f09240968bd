"""RWKV6 ("Finch") block: time-mix with data-dependent decay + channel-mix,
as ``repro.nn.rwkv``, for training, prefill and decode.

The WKV recurrence runs through ``ops.wkv6``: the hand-written kernel on
the card (forward and backward), its plain twin on the CPU.  The JAX
package's training path computes the same function in its chunked form
(``_wkv_chunked``); the kernel is sequential and needs no decay clamp for
its numbers, but the clamp stays, since it is part of the model.

Serving carries ``init_rwkv_state``'s ``{"wkv", "shift_tm", "shift_cm"}``:
a prompt runs the kernel from ``state["wkv"]`` (``_wkv_chunked`` with
``s0`` there), and each decode step runs it at S = 1 from that state,
where the reference runs its one-token ``_wkv_step``; both return the
output in float32.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, ref
from repro_torch.nn.initializers import normal_init, truncated_lecun
from repro_torch.nn.linear import apply_linear

DECAY_CLAMP = 4.0  # per-step |log decay| bound (repro/nn/rwkv.py DECAY_CLAMP)


def init_rwkv_time_mix(cfg, generator: torch.Generator, lead=()):
    """Time-mix params with the shapes of ``init_rwkv_time_mix``, each with
    the leading ``lead`` axes (``(L,)`` for the stacked layout)."""
    r = cfg.rwkv
    d, ts = cfg.d_model, r.token_shift_lora_dim
    n_heads = d // r.head_dim
    device = generator.device
    fan = len(lead)

    def lecun(*shape):
        return truncated_lecun(generator, (*lead, *shape), fan_in_axis=fan)

    def normal(*shape):
        return normal_init(generator, (*lead, *shape), 0.02)

    return {
        "mu_x": normal(d),
        "mu": normal(5, d),  # ddlerp mix params of (w, k, v, r, g)
        "ts_lora_a": lecun(d, 5 * ts),
        "ts_lora_b": torch.zeros((*lead, 5, ts, d), device=device),
        "wr": {"w": lecun(d, d)},
        "wk": {"w": lecun(d, d)},
        "wv": {"w": lecun(d, d)},
        "wg_a": lecun(d, r.gate_lora_dim),
        "wg_b": lecun(r.gate_lora_dim, d),
        "w0": normal(d) - 0.6,  # decay bias (pre-clamp)
        "wd_a": lecun(d, r.decay_lora_dim),
        "wd_b": torch.zeros((*lead, r.decay_lora_dim, d), device=device),
        "u": normal(n_heads, r.head_dim),  # bonus
        "ln_out_scale": torch.ones((*lead, n_heads, r.head_dim), device=device),
        "wo": {"w": lecun(d, d)},
    }


def init_rwkv_channel_mix(cfg, generator: torch.Generator, lead=()):
    """Channel-mix params with the shapes of ``init_rwkv_channel_mix``."""
    d, ff = cfg.d_model, cfg.d_ff
    fan = len(lead)

    def lecun(*shape):
        return {"w": truncated_lecun(generator, (*lead, *shape), fan_in_axis=fan)}

    return {
        "mu_k": normal_init(generator, (*lead, d), 0.02),
        "mu_r": normal_init(generator, (*lead, d), 0.02),
        "wk": lecun(d, ff),
        "wv": lecun(ff, d),
        "wr": lecun(d, d),
    }


def _token_shift(x, prev):
    """(B, S, d) shifted right by one; position 0 takes ``prev`` (B, d)."""
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


def _ddlerp(params, x, xs):
    """Data-dependent interpolation giving the 5 mixed inputs (w, k, v, r,
    g), in that order: (..., 5, d)."""
    base = x + (xs - x) * params["mu_x"].to(x.dtype)
    lora = torch.tanh(base @ params["ts_lora_a"].to(x.dtype))
    lora = lora.reshape(*x.shape[:-1], 5, -1)
    adj = torch.einsum("...ct,ctd->...cd", lora, params["ts_lora_b"].to(x.dtype))
    mu = params["mu"].to(x.dtype) + adj
    return x[..., None, :] + (xs - x)[..., None, :] * mu


def _group_norm(x, scale, eps: float = 1e-5):
    """Per-head layer norm of (B, S, H, K) with the population variance
    (``jnp.var``), in the dtype of ``x``."""
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + eps) * scale


def time_mix_apply(params, cfg, x, state: Optional[dict] = None):
    """RWKV6 time-mix.  x: (B, S, d).  Returns (out, new_state_parts) with
    ``{"wkv": (B, H, K, K) float32, "shift_tm": (B, d) float32}``.

    ``state=None`` is the training path; with a state, S > 1 tokens are
    the prefill-with-state branch and S = 1 the decode step (``_wkv_step``
    in the reference), both through the same kernel from ``state["wkv"]``.
    """
    b, s, d = x.shape
    hd = cfg.rwkv.head_dim
    n_heads = d // hd
    prev = state["shift_tm"] if state is not None else torch.zeros((b, d), dtype=x.dtype, device=x.device)
    xs = _token_shift(x, prev.to(x.dtype))
    mixed = _ddlerp(params, x, xs)  # (B, S, 5, d)
    xw, xk, xv, xr, xg = mixed.unbind(dim=-2)

    r = apply_linear(params["wr"], xr)
    k = apply_linear(params["wk"], xk)
    v = apply_linear(params["wv"], xv)
    g = F.silu((xg @ params["wg_a"].to(x.dtype)) @ params["wg_b"].to(x.dtype))

    decay_raw = params["w0"].float() + torch.tanh(xw.float() @ params["wd_a"]) @ params["wd_b"]
    logw = torch.clamp(-torch.exp(decay_raw), -DECAY_CLAMP, -1e-4)

    def split(t):
        return t.reshape(b, s, n_heads, hd)

    s0 = None if state is None else state["wkv"].float().contiguous()
    out, wkv_state = ops.wkv6(split(r), split(k), split(v), split(logw), params["u"].float(), s0)

    out = _group_norm(out, params["ln_out_scale"].float())
    out = out.reshape(b, s, d).to(x.dtype) * g
    out = apply_linear(params["wo"], out)
    return out, {"wkv": wkv_state, "shift_tm": x[:, -1].float()}


def channel_mix_apply(params, cfg, x, state: Optional[dict] = None, peft: Optional[dict] = None,
                      lora_scale: float = 1.0):
    """RWKV6 channel-mix; its LoRA (``peft = {"up", "down"}``) runs through
    ``apply_linear`` and so the ``lora_matmul`` kernel.  Returns (out,
    ``{"shift_cm": (B, d) float32}``)."""
    b, s, d = x.shape
    peft = peft or {}
    prev = state["shift_cm"] if state is not None else torch.zeros((b, d), dtype=x.dtype, device=x.device)
    xs = _token_shift(x, prev.to(x.dtype))
    xk = x + (xs - x) * params["mu_k"].to(x.dtype)
    xr = x + (xs - x) * params["mu_r"].to(x.dtype)
    k = torch.square(torch.relu(apply_linear(params["wk"], xk, peft.get("up"), lora_scale)))
    kv = apply_linear(params["wv"], k, peft.get("down"), lora_scale)
    out = torch.sigmoid(apply_linear(params["wr"], xr)) * kv
    return out, {"shift_cm": x[:, -1].float()}


def wkv_sequential_ref(r, k, v, logw, u):
    """The oracle, as the reference's: the WKV recurrence token by token in
    plain torch (``kernels.ref.wkv6_plain``), r, k, v, logw (B, S, H, K)
    and u (H, K) -> (out (B, S, H, V) float32, final state (B, H, K, V)
    float32) from a zero state."""
    return ref.wkv6_plain(r, k, v, logw, u)


def init_rwkv_state(cfg, batch: int, device=None):
    """The decode state of one RWKV6 layer, zero, float32, as
    ``repro.nn.rwkv.init_rwkv_state``: ``{"wkv": (B, H, K, K), "shift_tm":
    (B, d), "shift_cm": (B, d)}``."""
    d, hd = cfg.d_model, cfg.rwkv.head_dim
    return {
        "wkv": torch.zeros((batch, d // hd, hd, hd), device=device),
        "shift_tm": torch.zeros((batch, d), device=device),
        "shift_cm": torch.zeros((batch, d), device=device),
    }
