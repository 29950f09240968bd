"""Plain PyTorch twins of the port's CUDA kernels.

Each twin computes what its kernel computes, in the same op order, with
ordinary tensor operations (the attention twin keeps its probabilities in
float32 where the bf16 kernel rounds them to bf16 for the tensor cores).  ``ops`` runs a twin for tensors on the CPU
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


def attention_plain(q, k, v, *, causal: bool = True, window: Optional[int] = None):
    """Masked softmax attention in float32, as ``attention_ref``
    (``repro/kernels/ref.py:8``) in the model's layout, with GQA indexed
    by head group instead of repeated.

    q: (B, S, H, D); k, v: (B, S, KV, D); query i sees key j iff ``j <= i``
    (causal) and ``j > i - window`` (window); masked scores are -1e30.
    Returns (B, S, H, D) in ``q.dtype``.  Differentiable by autograd.
    """
    b, s, h, d = q.shape
    kv = k.shape[2]
    qg = q.float().reshape(b, s, kv, h // kv, d)
    scores = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.float()) * (d**-0.5)
    pos = torch.arange(s, device=q.device)
    ok = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        ok = ok & (pos[None, :] <= pos[:, None])
    if window is not None and window > 0:
        ok = ok & (pos[None, :] > pos[:, None] - window)
    scores = torch.where(ok, scores, torch.full((), NEG_INF, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrqk,bkgd->bqgrd", probs, v.float())
    return out.reshape(b, s, h, d).to(q.dtype)


def lora_matmul_plain(x, w, a, b, *, alpha: float = 1.0):
    """``x @ W + alpha * (x @ A) @ B`` in the op order of the TPU kernel
    (``repro/kernels/lora_matmul.py:_lora_kernel``): float32 dots, the
    rank-r bottleneck rounded to ``x.dtype`` before its second dot, one
    cast of ``main + alpha * side``.  x: (M, K); w: (K, N); a: (K, r);
    b: (r, N).  Returns (M, N) in ``x.dtype``.  Differentiable by autograd.
    """
    main = x.float() @ w.float()
    t = (x.float() @ a.float()).to(x.dtype)
    side = t.float() @ b.float()
    return (main + alpha * side).to(x.dtype)
