"""Plain PyTorch twins of the port's CUDA kernels.

Each twin computes what its kernel computes, in the same op order, with
ordinary tensor operations (the attention twin keeps its probabilities in
float32 where the bf16 kernel rounds them to bf16 for the tensor cores).  ``ops`` runs a twin for tensors on the CPU
(the tests), and ``chip_smoke.py`` holds each kernel against its twin on
the card.  The twins are no yardstick of speed.

The reference's oracle names (``attention_ref``, ``wkv6_ref``,
``mamba_scan_ref``, ``lora_matmul_ref``, ``segmented_lora_ref``) keep its
signatures, layouts and return values, each over its twin.
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


def _decode_bias(q_positions, k_positions, window: Optional[int]):
    """(B, S) float32: 0 at the live slots (``kpos <= qpos``, and ``kpos >
    qpos - window``), -1e30 elsewhere (``_mask_bias``'s finite mask)."""
    qp = q_positions.long()[:, None]
    kp = k_positions.long()
    ok = kp <= qp
    if window is not None:
        ok = ok & (kp > qp - window)
    return torch.where(ok, 0.0, NEG_INF).to(torch.float32)


def decode_attention_plain(
    q, k_cache, v_cache, q_positions, k_positions, *, window: Optional[int] = None, return_lse: bool = False
):
    """Single-query GQA attention over a batched ring cache, as ``_sdpa``
    with the bias of ``_mask_bias`` (``repro/nn/attention.py:48-83``) but
    in float32 throughout, like the kernel.

    q: (B, H, D); k_cache, v_cache: (B, S, KV, D); q_positions: (B,);
    k_positions: (B, S) absolute slot positions (INT32_MAX = never written).
    Returns (B, H, D) in ``q.dtype``, and with ``return_lse`` the (B, H)
    float32 log-sum-exp of the masked scaled scores.
    """
    b, h, d = q.shape
    kv = k_cache.shape[2]
    qg = q.float().reshape(b, kv, h // kv, d)
    scores = torch.einsum("bgrd,bsgd->bgrs", qg, k_cache.float()) * (d**-0.5)
    scores = scores + _decode_bias(q_positions, k_positions, window)[:, None, None, :]
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrs,bsgd->bgrd", probs, v_cache.float()).reshape(b, h, d).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(scores, dim=-1).reshape(b, h)
    return out


def decode_scores_plain(q, k_cache, *, scale: float):
    """``flash_decode_scores``' twin: q (B, H, Dr) against k_cache (B, S,
    KV, Dr) -> (B, H, S) float32, ``scale · q · k`` over the Dr dims."""
    b, h, d = q.shape
    kv = k_cache.shape[2]
    scores = torch.einsum("bgrd,bsgd->bgrs", q.float().reshape(b, kv, h // kv, d), k_cache.float()) * scale
    return scores.reshape(b, h, -1)


def decode_combine_plain(scores, v_cache, q_positions, k_positions, *, window: Optional[int] = None, dtype=None):
    """``flash_decode_combine``'s twin: the masked softmax of the summed
    scores (B, H, S) and P V over v_cache (B, S, KV, Dr).  Returns (out (B,
    H, Dr) in ``dtype`` (default ``v_cache``'s), lse (B, H) float32)."""
    b, h, s = scores.shape
    kv, d = v_cache.shape[2], v_cache.shape[3]
    masked = (scores.float() + _decode_bias(q_positions, k_positions, window)[:, None, :]).reshape(b, kv, h // kv, s)
    out = torch.einsum("bgrs,bsgd->bgrd", torch.softmax(masked, dim=-1), v_cache.float()).reshape(b, h, d)
    return out.to(v_cache.dtype if dtype is None else dtype), torch.logsumexp(masked, dim=-1).reshape(b, h)


def attention_plain(q, k, v, *, causal: bool = True, window: Optional[int] = None):
    """Masked softmax attention in float32, as ``attention_ref``
    (``repro/kernels/ref.py:8``) in the model's layout, with GQA indexed
    by head group instead of repeated.

    q: (B, S, H, D); k, v: (B, S_kv, KV, D) (S_kv != S: cross-attention,
    queries 0 .. S-1 over keys 0 .. S_kv-1); query i sees key j iff ``j <=
    i`` (causal) and ``j > i - window`` (window); masked scores are -1e30.
    Returns (B, S, H, D) in ``q.dtype``.  Differentiable by autograd.
    """
    b, s, h, d = q.shape
    skv, kv = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, s, kv, h // kv, d)
    scores = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.float()) * (d**-0.5)
    qpos, kpos = torch.arange(s, device=q.device), torch.arange(skv, device=q.device)
    ok = torch.ones((s, skv), dtype=torch.bool, device=q.device)
    if causal:
        ok = ok & (kpos[None, :] <= qpos[:, None])
    if window is not None and window > 0:
        ok = ok & (kpos[None, :] > qpos[:, None] - window)
    scores = torch.where(ok, scores, torch.full((), NEG_INF, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrqk,bkgd->bqgrd", probs, v.float())
    return out.reshape(b, s, h, d).to(q.dtype)


def lora_matmul_plain(x, w, a, b, *, alpha: float = 1.0):
    """``x @ W + alpha * (x @ A) @ B`` in the op order of the TPU kernel
    (``repro/kernels/lora_matmul.py:_lora_kernel``): float32 dots, the
    rank-r bottleneck rounded to ``x.dtype`` before its second dot, one
    cast of ``main + alpha * side``.  x: (M, K); w: (K, N); a: (K, r);
    b: (r, N).  Grouped: a (G, K, r), b (G, r, N), and the rows of group g
    (the g-th of G equal slices of x) take the ungrouped twin with A_g and
    B_g, group by group.  Returns (M, N) in ``x.dtype``.  Differentiable by
    autograd.
    """
    if a.ndim == 3:
        rows = x.shape[0] // a.shape[0]
        return torch.cat([lora_matmul_plain(x[g * rows:(g + 1) * rows], w, a[g], b[g], alpha=alpha)
                          for g in range(a.shape[0])])
    main = x.float() @ w.float()
    t = (x.float() @ a.float()).to(x.dtype)
    side = t.float() @ b.float()
    return (main + alpha * side).to(x.dtype)


def wkv6_plain(r, k, v, logw, u, s0=None):
    """The WKV6 recurrence token by token, as ``wkv6_ref``
    (``repro/kernels/ref.py:26``), with a state in and out.  With S the
    (K, V) state of a head and w = exp(logw)::

        out_t[v] = sum_k r_t[k] (S[k, v] + u[k] k_t[k] v_t[v])
        S[k, v] <- w_t[k] S[k, v] + k_t[k] v_t[v]

    r, k, v, logw: (B, S, H, K); u: (H, K); s0: (B, H, K, V) or None (zero).
    Returns (out (B, S, H, V) float32, final state (B, H, K, V) float32).
    """
    b, s, h, kd = r.shape
    rf, kf, vf, wf = (t.float() for t in (r, k, v, logw.exp()))
    uf = u.float()[None, :, :, None]
    state = torch.zeros((b, h, kd, vf.shape[-1]), dtype=torch.float32, device=r.device) if s0 is None else s0.float()
    outs = []
    for t in range(s):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]  # (B, H, K, V)
        outs.append(torch.einsum("bhk,bhkv->bhv", rf[:, t], state + uf * kv))
        state = wf[:, t, :, :, None] * state + kv
    out = torch.stack(outs, dim=1) if outs else torch.zeros_like(vf)
    return out, state


def wkv6_bwd_plain(r, k, v, logw, u, s0, dout, dstate=None):
    """The backward of ``wkv6_plain``, step by step.  With S_t the state
    after token t (S_{-1} = s0) and G_t = dL/dS_t (G_{S-1} = ``dstate``)::

        G_{t-1}   = diag(w_t) G_t + r_t do_t^T
        dr_t[k]   = sum_v S_{t-1}[k, v] do_t[v] + u[k] k_t[k] (v_t . do_t)
        dk_t[k]   = sum_v G_t[k, v] v_t[v] + u[k] r_t[k] (v_t . do_t)
        dv_t[v]   = sum_k G_t[k, v] k_t[k] + (sum_k r_t[k] u[k] k_t[k]) do_t[v]
        dlogw_t[k] = w_t[k] sum_v G_t[k, v] S_{t-1}[k, v]
        du[k]     = sum_{b, t} r_t[k] k_t[k] (v_t . do_t)

    Every per-token state is kept (the kernel recomputes them instead).
    Returns (dr, dk, dv) in ``r.dtype``, dlogw and du float32, and ds0 =
    G_{-1} (float32; None when ``s0`` is None).
    """
    b, s, h, kd = r.shape
    rf, kf, vf, wf, do = (t.float() for t in (r, k, v, logw.exp(), dout))
    uf = u.float()
    states = [torch.zeros((b, h, kd, vf.shape[-1]), dtype=torch.float32, device=r.device) if s0 is None else s0.float()]
    for t in range(s - 1):
        states.append(wf[:, t, :, :, None] * states[-1] + kf[:, t, :, :, None] * vf[:, t, :, None, :])
    g = torch.zeros_like(states[0]) if dstate is None else dstate.float()
    dr, dk, dv, dlogw = (torch.empty_like(rf) for _ in range(4))
    vdo = torch.sum(vf * do, dim=-1, keepdim=True)  # (B, S, H, 1)
    ruk = torch.sum(rf * uf * kf, dim=-1, keepdim=True)
    for t in reversed(range(s)):
        prev = states[t]  # S_{t-1}
        dr[:, t] = torch.einsum("bhkv,bhv->bhk", prev, do[:, t]) + uf * kf[:, t] * vdo[:, t]
        dk[:, t] = torch.einsum("bhkv,bhv->bhk", g, vf[:, t]) + uf * rf[:, t] * vdo[:, t]
        dv[:, t] = torch.einsum("bhkv,bhk->bhv", g, kf[:, t]) + ruk[:, t] * do[:, t]
        dlogw[:, t] = wf[:, t] * torch.sum(g * prev, dim=-1)
        g = wf[:, t, :, :, None] * g + rf[:, t, :, :, None] * do[:, t, :, None, :]
    du = torch.sum(rf * kf * vdo, dim=(0, 1))
    return dr.to(r.dtype), dk.to(r.dtype), dv.to(r.dtype), dlogw, du, (g if s0 is not None else None)


def mamba_scan_plain(dt, x, bmat, cmat, a, dvec, h0=None):
    """The selective scan token by token, as ``mamba_scan_ref``
    (``repro/kernels/ref.py:45``), from the entering state ``h0`` (B, D, N)
    (zero when None), returning the final state too.  Per batch row,
    channel d and state n, in float32::

        h_t[d, n] = exp(dt_t[d] A[d, n]) h_{t-1}[d, n] + (dt_t[d] x_t[d]) B_t[n]
        y_t[d]    = sum_n h_t[d, n] C_t[n] + D[d] x_t[d]

    dt, x: (B, S, D); bmat, cmat: (B, S, N); a: (D, N) (negative); dvec:
    (D,).  Returns (y (B, S, D) in ``x.dtype``, final state (B, D, N)
    float32).
    """
    dtf, xf, bf, cf, af, df = (t.float() for t in (dt, x, bmat, cmat, a, dvec))
    b, s, d = x.shape
    if h0 is None:
        h = torch.zeros((b, d, af.shape[-1]), dtype=torch.float32, device=x.device)
    else:
        h = h0.float()
    ys = []
    for t in range(s):
        a_t = torch.exp(dtf[:, t, :, None] * af[None])  # (B, D, N)
        h = a_t * h + (dtf[:, t] * xf[:, t])[..., None] * bf[:, t, None, :]
        ys.append(torch.sum(h * cf[:, t, None, :], dim=-1) + df[None] * xf[:, t])
    y = torch.stack(ys, dim=1) if ys else torch.zeros_like(xf)
    return y.to(x.dtype), h


def mamba_scan_bwd_plain(dt, x, bmat, cmat, a, dvec, dy):
    """The backward of ``mamba_scan_plain`` (the final state takes no
    cotangent), step by step.  With a_t = exp(dt_t A), u_t = dt_t x_t, h_t
    the state after token t (h_{-1} = 0) and g_t = dL/dh_t::

        g_t       = a_{t+1} g_{t+1} + dy_t C_t          (g_S = 0)
        q_t       = g_t a_t h_{t-1}
        d_dt_t[d] = sum_n q_t[d, n] A[d, n] + x_t[d] du_t[d],  du_t[d] = sum_n g_t[d, n] B_t[n]
        dx_t[d]   = dt_t[d] du_t[d] + D[d] dy_t[d]
        dB_t[n]   = sum_d g_t[d, n] u_t[d]
        dC_t[n]   = sum_d dy_t[d] h_t[d, n]
        dA[d, n]  = sum_{b, t} q_t[d, n] dt_t[d]
        dD[d]     = sum_{b, t} dy_t[d] x_t[d]

    Every per-token state is kept (the kernel recomputes them instead).
    Returns (d_dt, dx) in the inputs' dtypes and dB, dC (B, S, N), dA
    (D, N), dD (D,) in float32.
    """
    dtf, xf, bf, cf, af, df, dyf = (t.float() for t in (dt, x, bmat, cmat, a, dvec, dy))
    b, s, d = x.shape
    n = af.shape[-1]
    states = [torch.zeros((b, d, n), dtype=torch.float32, device=x.device)]
    for t in range(s):
        a_t = torch.exp(dtf[:, t, :, None] * af[None])
        states.append(a_t * states[-1] + (dtf[:, t] * xf[:, t])[..., None] * bf[:, t, None, :])
    g = torch.zeros_like(states[0])
    d_dt, dx = torch.empty_like(dtf), torch.empty_like(xf)
    db, dc = torch.empty_like(bf), torch.empty_like(cf)
    da = torch.zeros_like(af)
    for t in reversed(range(s)):
        dy_t, dt_t, x_t = dyf[:, t], dtf[:, t], xf[:, t]
        g = g + dy_t[..., None] * cf[:, t, None, :]  # dL/dh_t
        dc[:, t] = torch.einsum("bd,bdn->bn", dy_t, states[t + 1])
        db[:, t] = torch.einsum("bdn,bd->bn", g, dt_t * x_t)
        du = torch.einsum("bdn,bn->bd", g, bf[:, t])
        a_t = torch.exp(dt_t[..., None] * af[None])
        q = g * a_t * states[t]
        d_dt[:, t] = torch.sum(q * af[None], dim=-1) + x_t * du
        dx[:, t] = dt_t * du + df[None] * dy_t
        da = da + torch.einsum("bdn,bd->dn", q, dt_t)
        g = a_t * g
    dd = torch.sum(dyf * xf, dim=(0, 1))
    return d_dt.to(dt.dtype), dx.to(x.dtype), db, dc, da, dd


# ------------------------------------------------------------- the reference's oracle names
def attention_ref(q, k, v, *, causal: bool = True, window=None):
    """q, k, v: (B, H, S, D) -> (B, H, S, D), the reference's naive masked
    softmax attention (``attention_plain`` in the heads-second layout)."""
    out = attention_plain(*(t.transpose(1, 2) for t in (q, k, v)), causal=causal, window=window)
    return out.transpose(1, 2)


def wkv6_ref(r, k, v, logw, u):
    """The sequential WKV6 recurrence from a zero state: r, k, v, logw (B,
    S, H, K), u (H, K) -> (B, S, H, V) in ``r.dtype``."""
    return wkv6_plain(r, k, v, logw, u)[0].to(r.dtype)


def mamba_scan_ref(dt, x, bmat, cmat, a, dvec):
    """The sequential selective scan from a zero state -> y (B, S, D) in
    ``x.dtype``."""
    return mamba_scan_plain(dt, x, bmat, cmat, a, dvec)[0]


def lora_matmul_ref(x, w, a, b, *, alpha: float = 1.0):
    """``x @ W + alpha (x @ A) @ B`` with every product in float32 (the
    bottleneck not rounded), one cast to ``x.dtype``."""
    return lora_matmul_plain(x.float(), w, a, b, alpha=alpha).to(x.dtype)


def segmented_lora_ref(x, w, a, b, idx, ranks):
    """Row i through pool slot ``idx[i]``'s adapter (its true rank masked,
    the scale folded into ``b``), in ``x.dtype``."""
    return segmented_lora_plain(x, w, a, b, idx, ranks)
