"""Serving utilities, as ``repro.serving.decode``.

``sharded_decode_attention``: decode over a KV cache sharded along the
*sequence* dimension across a mesh axis (long-context serving).  Each rank
computes its shard's unnormalised attention, and the partials merge with a
log-sum-exp combine of three ``all_reduce``s, so a decode step moves
O(heads x head_dim) per rank instead of gathering an O(seq) cache.  It is
plain float32 arithmetic, as in the reference, which runs it outside any
Pallas kernel.

``generate``: greedy generation with the decode caches, one Python loop of
``serve_step`` calls at a scalar position that serves both of the
reference's loops (its scan and its while loop).
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _partial_attention(q, k, v, k_positions, q_position, window):
    """Unnormalised attention over one KV shard, in float32.

    q: (B, H, D); k, v: (B, S_shard, KV, D); k_positions: (S_shard,).
    Returns (acc (B, H, D), m (B, H), l (B, H)).  A masked slot scores
    -1e30, so a shard with no visible slot has m = -1e30, and its scale
    in the combine underflows to 0 (an -inf fill would make it NaN)."""
    n_rep = q.shape[1] // k.shape[2]
    kk = k.repeat_interleave(n_rep, dim=2).float()  # (B, S, H, D)
    vv = v.repeat_interleave(n_rep, dim=2).float()
    scores = torch.einsum("bhd,bshd->bhs", q.float(), kk) * (q.shape[-1] ** -0.5)
    ok = k_positions <= q_position
    if window is not None and window > 0:
        ok = ok & (k_positions > q_position - window)
    scores = scores.masked_fill(~ok[None, None, :], -1e30)
    m = scores.amax(dim=-1)
    p = torch.exp(scores - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bhs,bshd->bhd", p, vv)
    return acc, m, l


def sharded_decode_attention(mesh, q, k_cache, v_cache, k_positions, q_position, *, window=None, axis: str = "data"):
    """Flash-decode over a sequence-sharded KV cache, in SPMD form: every
    rank of ``mesh``'s ``axis`` calls it with the replicated ``q`` (B, H, D)
    and its own shard of ``k_cache``/``v_cache`` (B, S_shard, KV, D) and of
    ``k_positions`` (S_shard,) (absolute slot positions).  ``q_position``
    is the query's position (an int or a 0-d tensor).  Returns the (B, H,
    D) attention output in ``q.dtype``, the same on every rank.
    """
    group = mesh.get_group(axis)
    acc, m, l = _partial_attention(q, k_cache, v_cache, k_positions, q_position, window)
    # log-sum-exp combine across the sequence shards
    m_glob = m.clone()
    dist.all_reduce(m_glob, op=dist.ReduceOp.MAX, group=group)
    scale = torch.exp(m - m_glob)
    l_glob = l * scale
    dist.all_reduce(l_glob, op=dist.ReduceOp.SUM, group=group)
    acc_glob = acc * scale[..., None]
    dist.all_reduce(acc_glob, op=dist.ReduceOp.SUM, group=group)
    return (acc_glob / torch.clamp(l_glob, min=1e-30)[..., None]).to(q.dtype)


def generate(serve_step, params, prompt_caches, first_token, start_pos: int, num_tokens: int, enc_kvs=None, *,
             eos_id=None, max_new_tokens=None, pad_id: int = 0):
    """Greedy generation.  Returns (tokens (B, num_tokens) int32, caches).

    Step i feeds the previous token at position ``start_pos + i``; an
    encoder-decoder's ``enc_kvs`` (its prefill's) go to every step.  With
    ``eos_id`` or ``max_new_tokens`` (a scalar or one budget per row) a row
    that emits ``eos_id`` or spends its budget is frozen: its later outputs
    are ``pad_id`` and it re-feeds its last live token, so the batch keeps
    its shape.  With both unset no row freezes, and the tokens are the
    unconditional loop's.  The stop flags stay on the device: the loop
    reads nothing back.
    """
    batch, device = first_token.shape[0], first_token.device
    token, caches, out = first_token, prompt_caches, []
    done = torch.zeros((batch,), dtype=torch.bool, device=device)
    budget = None
    if max_new_tokens is not None:
        budget = torch.as_tensor(max_new_tokens, dtype=torch.int32, device=device).expand(batch)
    pad = torch.tensor(pad_id, dtype=torch.int32, device=device)
    for i in range(num_tokens):
        if enc_kvs is None:
            _, nxt, caches = serve_step(params, token, start_pos + i, caches)
        else:
            _, nxt, caches = serve_step(params, token, start_pos + i, caches, enc_kvs)
        out.append(torch.where(done, pad, nxt[:, 0]))
        new_done = done
        if eos_id is not None:
            new_done = new_done | (~done & (nxt[:, 0] == eos_id))
        if budget is not None:
            new_done = new_done | (i + 1 >= budget)
        token = torch.where(done[:, None], token, nxt)  # frozen rows re-feed their token
        done = new_done
    return _stacked(out, first_token), caches


def _stacked(columns, first_token):
    if not columns:
        return torch.zeros((first_token.shape[0], 0), dtype=torch.int32, device=first_token.device)
    return torch.stack(columns, dim=1)
