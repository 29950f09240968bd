"""GQA attention: the cache-free path and the two serving-cache paths.

* cache-free (training, evaluation) — the ``flash_attention`` kernel over
  the positions 0..S-1 of each sequence, causal or bidirectional, with the
  config's window, in the model's own (B, S, heads, hd) layout; GQA is
  indexed inside the kernel.  Its backward is a kernel too.
* batched serving cache (``pos`` (B,)) — one new token per row, each row at
  its own depth: the token's K/V are written into a ring at ``pos %
  cache_len`` (in place), and decode attention runs through the
  ``flash_decode`` kernel with per-row query and slot positions.
* scalar-position cache (``pos`` (), every row at one depth; the prefill
  and ``generate``) — S new tokens written at ``pos`` (in place), as
  ``repro.nn.attention.attention_apply``: at ``pos == 0`` the
  ``flash_attention`` kernel over the new K/V; one token at ``pos > 0``
  takes the batched path with ``pos`` broadcast to (B,); more than one at
  ``pos > 0``, one ``flash_decode`` launch a new token against the ring,
  whose query and slot positions give the reference's mask; a prefill of at least
  ``cache_len`` tokens attends over its own K/V (``flash_attention`` with
  the window) and keeps the last ``cache_len`` in the ring, rolled so that
  position p sits in slot ``p % cache_len``.  The scalar ``pos`` lives on
  the host (a CPU tensor), so reading it syncs nothing.

A tensor-parallel step (``tp``, a ``sharding.collectives.Comm``) runs the
rank's heads with either cache, cut by the reference's ``cache_specs``
(``_tp_cache_attention``): the KV heads over ``model``, else the head dim,
else whole, and with ``Comm.seq_shard`` the sequence over the data axes.

``multi_head_attention`` is the reference's position-masked attention as a
public function: q (B, Sq, H, hd) over k, v (B, Skv, KV, hd) with the mask
of ``repro.nn.attention._mask_bias`` over absolute positions, each case on
a kernel (its docstring lists them).

Cross-attention (whisper's decoder over its encoder's output,
``cross_attention_apply``) takes K/V that ``encode_cross_kv`` computed once
a sequence: no rotary and no mask, queries at positions 0..S-1 over every
encoder frame.  Over S > 1 queries it runs the ``flash_attention`` kernel
with a key length of its own; a decode step's one query runs
``flash_decode`` with every encoder slot live.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.nn.initializers import truncated_lecun
from repro_torch.nn.linear import apply_linear
from repro_torch.nn.norms import apply_rmsnorm
from repro_torch.nn.rotary import apply_rotary
from repro_torch.sharding.collectives import Shard

INT32_MAX = 2**31 - 1


def _proj(generator, lead, d_in, d_out, place=None):
    proj = {"w": truncated_lecun(generator, (*lead, d_in, d_out), fan_in_axis=len(lead))}
    return place(proj) if place is not None else proj


def init_attention(cfg, generator: torch.Generator, *, lead=(), place=None):
    """``{"wq", "wk", "wv", "wo"}`` (truncated LeCun, drawn in that order;
    zero biases on q/k/v with ``attention_bias``) and with ``qk_norm`` the
    unit ``q_norm``/``k_norm`` scales, as the reference's
    ``init_attention``, on the generator's device.  ``lead`` (L,) draws L
    layers stacked; ``place(proj)``, when given, takes each projection as
    soon as it is drawn."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    attn = {"wq": _proj(generator, lead, d, h * hd, place), "wk": _proj(generator, lead, d, kv * hd, place),
            "wv": _proj(generator, lead, d, kv * hd, place), "wo": _proj(generator, lead, h * hd, d, place)}
    if cfg.attention_bias:
        for name, width in (("wq", h * hd), ("wk", kv * hd), ("wv", kv * hd)):
            attn[name]["b"] = torch.zeros((*lead, width), device=generator.device)
    if cfg.qk_norm:
        attn["q_norm"] = {"scale": torch.ones((*lead, hd), device=generator.device)}
        attn["k_norm"] = {"scale": torch.ones((*lead, hd), device=generator.device)}
    return attn


def init_cross_attention(cfg, generator: torch.Generator, *, lead=(), place=None):
    """Whisper's cross-attention (queries from the decoder, K/V from the
    encoder): ``init_attention``'s tree, as the reference's."""
    return init_attention(cfg, generator, lead=lead, place=place)


def _one_run(q_positions, k_positions) -> bool:
    """True when both 1-D position vectors are one and the same run p0,
    p0+1, ..., p0+S-1: the mask then depends on index differences alone.
    Reads the positions on the host."""
    if q_positions.shape != k_positions.shape or not torch.equal(q_positions, k_positions):
        return False
    run = torch.arange(q_positions.shape[0], device=q_positions.device) + q_positions[:1]
    return torch.equal(q_positions.long(), run.long())


def multi_head_attention(q, k, v, *, q_positions, k_positions, causal: bool = True, window=None):
    """Masked GQA attention over absolute positions, as the reference's
    ``multi_head_attention``: query i sees key j iff ``kpos_j <= qpos_i``
    (causal) and ``kpos_j > qpos_i - window`` (window).  q: (B, Sq, H,
    hd); k, v: (B, Skv, KV, hd); positions (Sq,) and (Skv,), or per row
    (B, Sq) and (B, Skv) (either broadcast over the rows).  Returns (B, Sq,
    H, hd) in ``q.dtype``.  Each case runs a kernel:

    * ``causal=False`` with no window, any positions (the mask keeps every
      key): one ``flash_attention`` launch, bidirectional, K/V of their
      own length;
    * 1-D ``q_positions`` equal to ``k_positions``, one contiguous run:
      one ``flash_attention`` launch with ``causal`` and ``window`` (the
      mask depends only on differences, so the run's offset drops out);
    * ``causal=True`` with any other positions: one ``flash_decode`` launch
      a query column, each with its rows' positions.

    The first two train through ``flash_attention``'s backward kernels.
    ``flash_decode`` has no backward, so the third raises ``ValueError``
    when an input requires a gradient; so does ``causal=False`` with a
    window over positions that are not one run, which no kernel takes.
    The reference reaches neither: its callers attend causally over a
    run or a decode cache, and whisper's encoder and cross-attention
    without a mask."""
    q_positions = torch.as_tensor(q_positions)
    k_positions = torch.as_tensor(k_positions)
    if not causal and window is None:
        return ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=False)
    if q_positions.ndim == 1 and k_positions.ndim == 1 and _one_run(q_positions, k_positions):
        return ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=causal, window=window)
    if not causal:
        raise ValueError("non-causal attention with a window takes positions that are one run, the same for "
                         "queries and keys: no kernel takes another mask")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise ValueError("masked attention at positions that are not one run decodes query by query through "
                         "flash_decode, which has no backward: call it without a gradient")
    b, sq = q.shape[:2]
    q_positions = q_positions.to(device=q.device, dtype=torch.int32).expand(b, sq)
    k_positions = k_positions.to(device=q.device, dtype=torch.int32).expand(b, k.shape[1]).contiguous()
    k, v = k.contiguous(), v.contiguous()
    return torch.stack([ops.flash_decode(q[:, t].contiguous(), k, v, q_positions[:, t].contiguous(), k_positions,
                                         window=window) for t in range(sq)], dim=1)


def ring_positions(pos, cache_len: int, lo: int = 0, n=None):
    """Absolute position held by each ring slot after this step's write,
    per row: ``(B, cache_len)`` int32, INT32_MAX where the slot was not
    written by the row's current request (never live); with ``lo`` and
    ``n``, only slots ``lo .. lo + n - 1`` of the ring."""
    last_pos = pos[:, None]  # one new token per row: last_pos = pos
    slots = torch.arange(lo, lo + (cache_len if n is None else n), dtype=pos.dtype, device=pos.device)
    k_positions = last_pos - torch.remainder(last_pos - slots[None, :], cache_len)
    return torch.where(k_positions < 0, INT32_MAX, k_positions).to(torch.int32)


def _scalar_cache_attention(cfg, q, k, v, positions, cache):
    """Attention of S new tokens written at the scalar position
    ``cache["pos"]`` (``_mask_bias``'s mask over the ring, as the
    reference's scalar-pos branch).  q: (B, S, H, hd); k, v: (B, S, KV,
    hd); positions: (S,) or (B, S), the new tokens' positions.  Writes the
    ring in place; returns (out (B, S, H, hd), new_cache)."""
    b, s = q.shape[:2]
    ck, cv, pos = cache["k"], cache["v"], cache["pos"]
    cache_len, p0 = ck.shape[1], int(pos)
    window = cfg.sliding_window
    if s >= cache_len:
        # a prompt past the ring: early queries need keys the ring drops,
        # so attend over the sequence's own K/V; the ring keeps the last
        # cache_len tokens, position p in slot p % cache_len
        shift = s % cache_len if s > cache_len else 0
        ck.copy_(torch.roll(k[:, -cache_len:].to(ck.dtype), shift, dims=1))
        cv.copy_(torch.roll(v[:, -cache_len:].to(cv.dtype), shift, dims=1))
        out = ops.flash_attention(q, k, v.contiguous(), causal=True, window=window)
        return out, {"k": ck, "v": cv, "pos": pos + s}
    write = p0 % cache_len
    if write + s > cache_len:
        raise ValueError(f"a write of {s} tokens at slot {write} would wrap the ring of {cache_len}; "
                         "the scalar-position cache writes a prompt without a wrap")
    ck[:, write : write + s] = k.to(ck.dtype)
    cv[:, write : write + s] = v.to(cv.dtype)
    if p0 == 0:
        # an empty ring: the new tokens attend over themselves, positions
        # 0 .. S-1, their K/V as the ring holds them
        kk, vv = (t.to(ck.dtype).to(q.dtype).contiguous() for t in (k, v))
        out = ops.flash_attention(q, kk, vv, causal=True, window=window)
    else:
        k_positions = ring_positions(torch.full((b,), p0 + s - 1, dtype=torch.int64, device=q.device), cache_len)
        q_positions = positions.to(device=q.device, dtype=torch.int32).expand(b, s)
        out = torch.stack([
            ops.flash_decode(q[:, t].contiguous(), ck, cv, q_positions[:, t].contiguous(), k_positions, window=window)
            for t in range(s)
        ], dim=1)
    return out, {"k": ck, "v": cv, "pos": pos + s}


def _cache_layout(cfg, cache) -> str:
    """How ``cache_specs`` cut this rank's ring over ``model``, read off its
    shape: ``dim`` (the head dim), ``heads`` (the KV heads) or ``whole``."""
    if cache["k"].shape[3] != cfg.resolved_head_dim:
        return "dim"
    return "heads" if cache["k"].shape[2] != cfg.num_kv_heads else "whole"


def _to_cache_layout(tp, layout: str, kv):
    """New K and V of this rank's KV heads, ``kv`` (2, B, n, kv_l, hd), as
    its cache holds them: as they are (``heads``), every head gathered over
    ``model`` (``whole``: each block of ``head_share`` ranks computed one
    head alike) or its slice of every head's dims (``dim``,
    ``Comm.head_dim_cut``)."""
    if layout == "heads":
        return kv
    if layout == "whole":
        return tp.all_gather(kv, "model", 3)[:, :, :, ::tp.head_share]
    return tp.head_dim_cut(kv[:, :, :, 0])


def _tp_cache_attention(cfg, tp, q, k, v, positions, cache):
    """A tensor-parallel step's attention with a decode cache: q (B, S,
    H / tp, hd), k and v (B, S, kv_l, hd) of the rank's heads (``Comm
    .kv_cols``), the rank's part of the ring in ``cache`` (``cache_specs``:
    ``_cache_layout``; with ``tp.seq_shard`` its slots ``lo .. lo + L - 1``
    of a ring of L times the data ranks).  Returns (out (B, S, H / tp, hd),
    new_cache), the ring written in place.

    * A prefill (scalar ``pos`` 0; a sharded prefill starts there, as the
      reference's does, else ``NotImplementedError``): ``flash_attention``
      on the local heads as the one-rank step runs it, then the ring's
      written slots that are the rank's, in its layout
      (``_to_cache_layout``).
    * A decode step (one token; either ``pos``): the new token's K/V into
      the rank's layout (``heads``: its own; ``whole``: gathered over
      ``model``; ``dim``: q, k and v gathered over ``model`` in one call, the
      rank's dims taken), written by the rank whose slots hold ``pos % ring``;
      then ``flash_decode`` on the local heads (``whole``: its KV heads'
      part of the ring), or for ``dim`` ``flash_decode_scores``, their sum
      over ``model`` and ``flash_decode_combine`` over every head and the
      rank's dims, gathered back to local heads; with ``seq_shard`` each
      data rank's output over its slots weighed by its log-sum-exp
      (``Comm.lse_combine``)."""
    b, s, h_l, hd = q.shape
    ck, cv, pos = cache["k"], cache["v"], cache["pos"]
    layout, window = _cache_layout(cfg, cache), cfg.sliding_window
    n_slots = ck.shape[1]
    ring = n_slots * (tp.n_data if tp.seq_shard else 1)
    lo = tp.data_index * n_slots if tp.seq_shard else 0
    if pos.ndim == 0 and (s > 1 or int(pos) == 0):
        if int(pos) != 0:
            raise NotImplementedError(f"a sharded prefill starts at position 0, as the reference's does, not at "
                                      f"{int(pos)}")
        if s >= ring:  # attention over the sequence's own K/V; the ring keeps the last `ring`, rolled
            out = ops.flash_attention(q, k, v.contiguous(), causal=True, window=window)
            kv = torch.roll(torch.stack([k[:, -ring:], v[:, -ring:]]).to(ck.dtype), s % ring, dims=2)
        else:
            kv = torch.stack([k, v]).to(ck.dtype)
            kk, vv = (t.to(q.dtype).contiguous() for t in kv)
            out = ops.flash_attention(q, kk, vv, causal=True, window=window)
        end = min(lo + n_slots, kv.shape[2])
        if end > lo:  # the written slots that are this rank's
            kv = _to_cache_layout(tp, layout, kv[:, :, lo:end])
            ck[:, :end - lo] = kv[0]
            cv[:, :end - lo] = kv[1]
        return out, {"k": ck, "v": cv, "pos": pos + s}
    if pos.ndim > 1 or s != 1:
        raise ValueError(f"a decode step writes one token a row at pos () or (B,), got S={s}, pos "
                         f"{tuple(pos.shape)}")
    row_pos = tp.rows(pos, b) if pos.ndim else torch.full((b,), int(pos), dtype=torch.int64, device=q.device)
    q_pos = positions.expand(b, 1)[:, 0].to(torch.int32).contiguous()
    q_new = q[:, 0]
    if layout == "dim":  # q, k and v of every head, and this rank's dims of them
        got = tp.all_gather(torch.cat([q[:, 0], k[:, 0], v[:, 0]], dim=1), "model", 1).view(b, tp.tp, h_l + 2, hd)
        d0, d1 = tp.tp_rank * ck.shape[3], (tp.tp_rank + 1) * ck.shape[3]
        q_new = got[:, :, :h_l, d0:d1].reshape(b, h_l * tp.tp, d1 - d0).contiguous()
        k_new, v_new = got[:, ::tp.head_share, h_l, d0:d1], got[:, ::tp.head_share, h_l + 1, d0:d1]
    elif layout == "whole":
        got = tp.all_gather(torch.stack([k[:, 0, 0], v[:, 0, 0]], dim=1), "model", 1).view(b, tp.tp, 2, hd)
        k_new, v_new = got[:, ::tp.head_share, 0], got[:, ::tp.head_share, 1]
    else:
        k_new, v_new = k[:, 0], v[:, 0]
    rows = torch.arange(b, device=q.device)
    slot = torch.remainder(row_pos, ring).long() - lo
    if tp.seq_shard:  # only the rank whose slots hold the position writes; the others write back what they hold
        mine = ((slot >= 0) & (slot < n_slots))[:, None, None]
        slot = slot.clamp(0, n_slots - 1)
        k_new, v_new = torch.where(mine, k_new.to(ck.dtype), ck[rows, slot]), torch.where(mine, v_new.to(cv.dtype),
                                                                                         cv[rows, slot])
    ck[rows, slot] = k_new.to(ck.dtype)
    cv[rows, slot] = v_new.to(cv.dtype)
    k_pos = ring_positions(row_pos, ring, lo, n_slots)
    if layout == "dim":
        scores = tp.all_reduce(ops.flash_decode_scores(q_new, ck, scale=hd**-0.5), "model")
        out, lse = ops.flash_decode_combine(scores, cv, q_pos, k_pos, window=window, dtype=q.dtype)
    else:
        kk, vv = ck, cv
        if layout == "whole":  # this rank's KV heads of the ring
            h0, h1 = (c // hd for c in tp.kv_cols(cfg))
            kk, vv = ck[:, :, h0:h1].contiguous(), cv[:, :, h0:h1].contiguous()
        out = ops.flash_decode(q_new.contiguous(), kk, vv, q_pos, k_pos, window=window, return_lse=tp.seq_shard)
        out, lse = out if tp.seq_shard else (out, None)
    if tp.seq_shard:
        out = tp.lse_combine(out, lse)
    if layout == "dim":  # every head's dims back, then this rank's heads
        out = tp.all_gather(out, "model", 2)[:, tp.tp_rank * h_l:(tp.tp_rank + 1) * h_l]
    return out[:, None], {"k": ck, "v": cv, "pos": pos + s}


def attention_apply(params, cfg, x, positions, *, causal=True, cache=None, peft=None, lora_scale=1.0, tp=None):
    """Self-attention over ``x`` (B, S, d).  Returns (out, new_cache).

    ``cache``: ``{"k": (B, S_max, KV, hd), "v": ..., "pos": ...}``, the
    batched serving cache (``pos`` (B,); S must then be 1) or the
    scalar-position cache (``pos`` (), a CPU tensor; S tokens written at
    ``pos``).  Its K/V tensors are updated in place and returned in
    ``new_cache`` with ``pos + S``.

    ``tp`` (a ``sharding.collectives.Comm``) runs the rank's heads of a
    tensor-parallel step: ``wq``, ``wk`` and ``wv`` are column-parallel
    (this rank's H / tp query heads and the KV heads they read, whole:
    ``Comm.kv_cols``, gathered by the step where a spec cuts a head),
    ``wo`` row-parallel, and ``flash_attention`` runs on the local heads;
    with a cache, ``_tp_cache_attention``.
    """
    peft = peft or {}
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    h, kvh = cfg.num_heads, cfg.num_kv_heads
    sq = skv = so = None
    if tp is not None:
        x = tp.enter(x)
        sq = Shard(tp, "col", *tp.cols(h * hd))
        skv = Shard(tp, "col", *tp.kv_cols(cfg))
        so = Shard(tp, "row", sq.lo, sq.hi)
        h, kvh = h // tp.tp, (skv.hi - skv.lo) // hd

    q = apply_linear(params["wq"], x, peft.get("q"), lora_scale, shard=sq).reshape(b, s, h, hd)
    k = apply_linear(params["wk"], x, peft.get("k"), lora_scale, shard=skv).reshape(b, s, kvh, hd)
    v = apply_linear(params["wv"], x, peft.get("v"), lora_scale, shard=skv).reshape(b, s, kvh, hd)

    if cfg.qk_norm:
        q = apply_rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = apply_rmsnorm(params["k_norm"], k, cfg.norm_eps)

    q = apply_rotary(q, positions, cfg.rope_theta)
    k = apply_rotary(k, positions, cfg.rope_theta)

    if cache is None:
        # positions only rotate q and k; the mask is over sequence indices
        out = ops.flash_attention(q, k, v.contiguous(), causal=causal, window=cfg.sliding_window)
        out = apply_linear(params["wo"], out.reshape(b, s, h * hd), peft.get("o"), lora_scale, shard=so)
        return out, None

    if tp is not None:
        out, new_cache = _tp_cache_attention(cfg, tp, q, k, v, positions, cache)
        return apply_linear(params["wo"], out.reshape(b, s, h * hd), peft.get("o"), lora_scale, shard=so), new_cache
    pos = cache["pos"]
    if pos.ndim == 0 and (s > 1 or int(pos) == 0):
        out, new_cache = _scalar_cache_attention(cfg, q, k, v, positions, cache)
        return apply_linear(params["wo"], out.reshape(b, s, h * hd), peft.get("o"), lora_scale), new_cache
    if pos.ndim > 1:
        raise ValueError(f"the cache's pos must be () or (B,), got {tuple(pos.shape)}")
    if s != 1:
        raise ValueError(
            f"batched KV cache (per-row positions) decodes one token per row per step, got S={s}"
        )
    ck, cv = cache["k"], cache["v"]
    cache_len = ck.shape[1]
    # a scalar pos (on the host): every row at one depth, filled on the
    # device so that no copy waits for the stream
    row_pos = pos if pos.ndim else torch.full((b,), int(pos), dtype=torch.int64, device=x.device)
    rows = torch.arange(b, device=x.device)
    write_pos = torch.remainder(row_pos, cache_len).long()
    ck[rows, write_pos] = k[:, 0].to(ck.dtype)
    cv[rows, write_pos] = v[:, 0].to(cv.dtype)
    # a recycled row still holds the previous tenant's K/V in the ring; the
    # slot positions keep it inert without a cache clear
    k_positions = ring_positions(row_pos, cache_len)
    out = ops.flash_decode(
        q[:, 0].contiguous(), ck, cv, positions.expand(b, 1)[:, 0].to(torch.int32).contiguous(),
        k_positions, window=cfg.sliding_window,
    )
    out = apply_linear(params["wo"], out.reshape(b, s, h * hd), peft.get("o"), lora_scale)
    return out, {"k": ck, "v": cv, "pos": pos + s}


def cross_slot_positions(b: int, s_enc: int, device) -> dict:
    """The decode's positions over an encoder's ``s_enc`` K/V slots, built
    once a sequence: slot j at position j (``k_positions`` (b, s_enc)) and
    every row's query at the last slot's (``q_positions`` (b,)), so that
    each slot is live."""
    return {"k_positions": torch.arange(s_enc, dtype=torch.int32, device=device).expand(b, s_enc).contiguous(),
            "q_positions": torch.full((b,), s_enc - 1, dtype=torch.int32, device=device)}


def cross_attention_apply(params, cfg, x, enc_kv, *, peft=None, lora_scale=1.0):
    """Cross-attention of ``x`` (B, S, d) over ``enc_kv`` (``{"k", "v"}``
    of (B, S_enc, KV, hd), from ``encode_cross_kv``, and at decode (S = 1)
    the ``cross_slot_positions``), as the reference's:
    the ``q`` and ``o`` projections (with their LoRA), no rotary, no mask.
    The encoder's K/V take no gradient here (they come from the frozen
    encoder), so the backward runs the attention's dQ kernel alone."""
    peft = peft or {}
    b, s, _ = x.shape
    hd, h = cfg.resolved_head_dim, cfg.num_heads
    q = apply_linear(params["wq"], x, peft.get("q"), lora_scale).reshape(b, s, h, hd)
    k, v = (enc_kv[name].to(x.dtype).contiguous() for name in ("k", "v"))
    if s == 1:  # one query over every encoder slot (``cross_slot_positions``)
        out = ops.flash_decode(q[:, 0].contiguous(), k, v, enc_kv["q_positions"], enc_kv["k_positions"])[:, None]
    else:
        out = ops.flash_attention(q, k, v, causal=False)
    return apply_linear(params["wo"], out.reshape(b, s, h * hd), peft.get("o"), lora_scale)


def encode_cross_kv(params, cfg, enc_out):
    """The encoder's K/V for one decoder layer's cross-attention, computed
    once a sequence: ``{"k", "v"}`` of (B, S_enc, KV, hd), no PEFT."""
    b, s, _ = enc_out.shape
    hd, kvh = cfg.resolved_head_dim, cfg.num_kv_heads
    return {"k": apply_linear(params["wk"], enc_out).reshape(b, s, kvh, hd),
            "v": apply_linear(params["wv"], enc_out).reshape(b, s, kvh, hd)}
