"""Plain PyTorch twins of the port's CUDA kernels.

Each twin computes what its kernel computes, in the same op order, with
ordinary tensor operations.  ``ops`` runs a twin for tensors on the CPU
(the tests), and ``chip_smoke.py`` holds each kernel against its twin on
the card.  The twins are no yardstick of speed.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def segmented_lora_plain(x, w, a, b, idx, ranks):
    """Gather formulation of the segmented multi-adapter LoRA matmul
    (``repro/kernels/ops.py:129-140``): row i uses pool slot ``idx[i]``.

    x: (M, K); w: (K, N); a: (NA, K, r_max); b: (NA, r_max, N) with the
    alpha/rank scale folded in; idx: (M,); ranks: (NA,).  float32 dots, the
    rank tail masked to zero, ``t`` rounded to ``x.dtype`` before the second
    dot, one cast of ``main + side``.  Returns (M, N) in ``x.dtype``.
    """
    idx = idx.long()
    ar = a[idx].to(x.dtype)  # (M, K, r_max)
    br = b[idx].to(x.dtype)  # (M, r_max, N)
    t = torch.einsum("mk,mkr->mr", x.float(), ar.float())
    rmask = torch.arange(a.shape[-1], device=x.device)[None, :] < ranks.long()[idx][:, None]
    t = torch.where(rmask, t, torch.zeros((), dtype=t.dtype, device=t.device))
    side = torch.einsum("mr,mrn->mn", t.to(x.dtype).float(), br.float())
    main = x.float() @ w.float()
    return (main + side).to(x.dtype)


def decode_attention_plain(
    q, k_cache, v_cache, q_positions, k_positions, *, window: Optional[int] = None
):
    """Single-query GQA attention over a batched ring cache, as ``_sdpa``
    with the bias of ``_mask_bias`` (``repro/nn/attention.py:48-83``) but
    in float32 throughout, like the kernel.

    q: (B, H, D); k_cache, v_cache: (B, S, KV, D); q_positions: (B,);
    k_positions: (B, S) absolute slot positions (INT32_MAX = never written).
    Returns (B, H, D) in ``q.dtype``.
    """
    b, h, d = q.shape
    kv = k_cache.shape[2]
    qg = q.float().reshape(b, kv, h // kv, d)
    scores = torch.einsum("bgrd,bsgd->bgrs", qg, k_cache.float()) * (d**-0.5)
    qp = q_positions.long()[:, None]
    kp = k_positions.long()
    ok = kp <= qp
    if window is not None:
        ok = ok & (kp > qp - window)
    bias = torch.where(ok, 0.0, NEG_INF).to(torch.float32)  # (B, S)
    probs = torch.softmax(scores + bias[:, None, None, :], dim=-1)
    out = torch.einsum("bgrs,bsgd->bgrd", probs, v_cache.float())
    return out.reshape(b, h, d).to(q.dtype)
