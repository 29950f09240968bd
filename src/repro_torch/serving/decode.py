"""Greedy generation with the decode caches, as ``repro.serving.decode
.generate``: one Python loop of ``serve_step`` calls at a scalar position
serves both of the reference's loops (its scan and its while loop).
(``sharded_decode_attention``, the sequence-sharded cache, is not ported.)
"""
from __future__ import annotations

import torch


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
