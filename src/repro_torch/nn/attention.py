"""GQA attention: the cache-free path and the batched serving-cache path.

* cache-free (training, evaluation) — the ``flash_attention`` kernel over
  the positions 0..S-1 of each sequence, causal or bidirectional, with the
  config's window, in the model's own (B, S, heads, hd) layout; GQA is
  indexed inside the kernel.  Its backward is a kernel too.
* batched serving cache — one new token per row, each row at its own
  depth: the token's K/V are written into a ring at ``pos % cache_len``
  (in place), and decode attention runs through the ``flash_decode``
  kernel with per-row query and slot positions.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.nn.linear import apply_linear
from repro_torch.nn.norms import apply_rmsnorm
from repro_torch.nn.rotary import apply_rotary

INT32_MAX = 2**31 - 1


def ring_positions(pos, cache_len: int):
    """Absolute position held by each ring slot after this step's write,
    per row: ``(B, cache_len)`` int32, INT32_MAX where the slot was not
    written by the row's current request (never live)."""
    last_pos = pos[:, None]  # one new token per row: last_pos = pos
    slots = torch.arange(cache_len, dtype=pos.dtype, device=pos.device)
    k_positions = last_pos - torch.remainder(last_pos - slots[None, :], cache_len)
    return torch.where(k_positions < 0, INT32_MAX, k_positions).to(torch.int32)


def attention_apply(params, cfg, x, positions, *, causal=True, cache=None, peft=None, lora_scale=1.0):
    """Self-attention over ``x`` (B, S, d).  Returns (out, new_cache).

    ``cache``: the batched serving cache ``{"k": (B, S_max, KV, hd), "v":
    ..., "pos": (B,)}``; S must then be 1.  Its K/V tensors are updated in
    place and returned in ``new_cache`` with ``pos + 1``.
    """
    peft = peft or {}
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    h, kvh = cfg.num_heads, cfg.num_kv_heads

    q = apply_linear(params["wq"], x, peft.get("q"), lora_scale).reshape(b, s, h, hd)
    k = apply_linear(params["wk"], x, peft.get("k"), lora_scale).reshape(b, s, kvh, hd)
    v = apply_linear(params["wv"], x, peft.get("v"), lora_scale).reshape(b, s, kvh, hd)

    if cfg.qk_norm:
        q = apply_rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = apply_rmsnorm(params["k_norm"], k, cfg.norm_eps)

    q = apply_rotary(q, positions, cfg.rope_theta)
    k = apply_rotary(k, positions, cfg.rope_theta)

    if cache is None:
        # positions only rotate q and k; the mask is over sequence indices
        out = ops.flash_attention(q, k, v.contiguous(), causal=causal, window=cfg.sliding_window)
        out = apply_linear(params["wo"], out.reshape(b, s, h * hd), peft.get("o"), lora_scale)
        return out, None

    pos = cache["pos"]
    if pos.ndim != 1:
        raise ValueError("the port's cache path is the batched serving cache: pos must be (B,)")
    if s != 1:
        raise ValueError(
            f"batched KV cache (per-row positions) decodes one token per row per step, got S={s}"
        )
    ck, cv = cache["k"], cache["v"]
    cache_len = ck.shape[1]
    rows = torch.arange(b, device=x.device)
    write_pos = torch.remainder(pos, cache_len).long()
    ck[rows, write_pos] = k[:, 0].to(ck.dtype)
    cv[rows, write_pos] = v[:, 0].to(cv.dtype)
    # a recycled row still holds the previous tenant's K/V in the ring; the
    # slot positions keep it inert without a cache clear
    k_positions = ring_positions(pos, cache_len)
    out = ops.flash_decode(
        q[:, 0].contiguous(), ck, cv, positions[:, 0].to(torch.int32).contiguous(),
        k_positions, window=cfg.sliding_window,
    )
    out = apply_linear(params["wo"], out.reshape(b, s, h * hd), peft.get("o"), lora_scale)
    return out, {"k": ck, "v": cv, "pos": pos + s}
