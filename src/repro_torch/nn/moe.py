"""Mixture of experts with GShard-style capacity dispatch, as
``repro.nn.moe``, in each of its dispatches.

Tokens (B, S, d) are cut into groups of at most 4 096; per group a top-k
router (softmax in float32, iterative argmax, gates renormalised over the
chosen experts) gives each token a position in each chosen expert's queue
of ``capacity`` slots (overflow is dropped).  The experts' MLP products are
``(E, groups * capacity, d)`` batched matmuls, which the JAX package also
leaves to XLA outside any Pallas kernel.  The aux loss is the Switch
load-balance loss over the first choice.  ``dispatch_mode`` (default
``cfg.moe_dispatch``) moves the tokens to their slots and back:

* ``einsum`` (and ``einsum_forced``): one-hot ``(G, g, E, C)`` dispatch and
  combine tensors and two einsums, the reference's arithmetic.  The
  one-hots are functions of the integer routing, so they are built outside
  autograd and built again in the backward (``_Dispatch``, ``_Combine``):
  autograd saves no ``(G, g, E, C)`` tensor, only the ``(G, g, k)`` slots,
  keeps and gates and the experts' output, and a gate's gradient is
  ``keep * <dout_t, eout[slot]>``.
* ``gather``: a ``(G, E * C)`` table of each slot's token (empty slots and
  overflow parked on a zero row), the tokens moved by ``index_select`` and
  combined by gathering each choice's slot: a permutation, no one-hot
  product.  Its backward gathers too (``_GatherTokens``), so no gradient
  row is summed by atomics.

A shared expert (``cfg.shared_expert``) adds ``mlp_apply`` of its own MLP
over every token, without PEFT, after the dispatch, as the reference does.
A cohort (``devices``) folds its devices' equal token blocks into the
batch: the groups are cut from one device's tokens, so no group spans two
devices and each device keeps its own capacity and drops, and the aux loss
comes back per device.

At most ``_WEIGHT_GATHER_MAX_TOKENS`` tokens (a decode step) take the
reference's weight gather instead (``_moe_weight_gather``), unless the
dispatch is ``einsum_forced``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.nn.initializers import truncated_lecun
from repro_torch.nn.mlp import gelu, init_mlp, mlp_apply

_DEFAULT_GROUP = 4096
_WEIGHT_GATHER_MAX_TOKENS = 8  # repro/nn/moe.py: at or below, decode gathers expert weights
# calls on the meta device that ran an upper bound of the work (the dry run reads it)
meta_upper_bounds = {"weight_gather": 0}
DISPATCH_MODES = ("einsum", "einsum_forced", "gather")


def init_moe(cfg, generator: torch.Generator):
    """One layer's router, stacked experts and, with ``cfg.shared_expert``,
    the shared expert (float32, SwiGLU or GELU as ``cfg.activation`` says),
    with the shapes of ``repro.nn.moe.init_moe``, drawn on the generator's
    device."""
    router = {"w": truncated_lecun(generator, (cfg.d_model, cfg.num_experts))}
    p = {"router": router, "experts": init_mlp(cfg, generator, lead=(cfg.num_experts,))}
    if cfg.shared_expert:
        p["shared"] = init_mlp(cfg, generator)
    return p


def _expert_ffn(experts, x):
    """Each expert's MLP on its own tokens.  x: (E, C, d) -> (E, C, d).
    The GELU branch adds ``up``'s bias after the activation, as the
    reference's ``_expert_ffn`` does."""
    if "gate" in experts:
        g = torch.matmul(x, experts["gate"]["w"].to(x.dtype))
        u = torch.matmul(x, experts["up"]["w"].to(x.dtype))
        h = F.silu(g) * u
    else:
        h = gelu(torch.matmul(x, experts["up"]["w"].to(x.dtype))) + experts["up"]["b"].to(x.dtype)[:, None, :]
    y = torch.matmul(h, experts["down"]["w"].to(x.dtype))
    return y + experts["down"]["b"].to(x.dtype)[:, None, :] if "b" in experts["down"] else y


def _route(params, cfg, xg, cap: int):
    """The reference's routing of groups ``xg`` (G, g, d): returns the
    renormalised gates (G, g, k) float32, the first choice's one-hot (G, g,
    E) and the probabilities (for the aux loss), and each choice's expert,
    queue position and keep flag (G, g, k).  Only the gates and the
    probabilities carry a gradient; the routing is integers."""
    e, k = cfg.num_experts, cfg.top_k
    logits = torch.einsum("gtd,de->gte", xg, params["router"]["w"].to(xg.dtype)).float()
    probs = torch.softmax(logits, dim=-1)  # (G, g, E)
    with torch.no_grad():
        remaining, idx = probs.detach().clone(), []
        for _ in range(k):  # take the argmax (first index on ties), zero it, repeat
            choice = torch.argmax(remaining, dim=-1, keepdim=True)
            idx.append(choice)
            remaining.scatter_(-1, choice, 0.0)
        expert = torch.cat(idx, dim=-1)  # (G, g, k)
        # capacity: each token's position in its expert's queue, the earlier
        # choices' kept tokens first; overflow dropped
        used = torch.zeros((xg.shape[0], 1, e), dtype=torch.int64, device=xg.device)
        pos, keep = [], []
        for i in range(k):
            mask_i = F.one_hot(expert[..., i], e)  # (G, g, E)
            pos_in_e = torch.cumsum(mask_i, dim=1) - mask_i + used
            pos_i = torch.gather(pos_in_e, -1, expert[..., i:i + 1])
            keep_i = pos_i < cap
            used = used + torch.sum(mask_i * (pos_in_e < cap), dim=1, keepdim=True)
            pos.append(pos_i)
            keep.append(keep_i)
        first = F.one_hot(expert[..., 0], e).to(probs.dtype)
    gates = torch.gather(probs, -1, expert)  # (G, g, k)
    gates = gates / (torch.sum(gates, dim=-1, keepdim=True) + 1e-9)
    return gates, first, probs, expert, torch.cat(pos, dim=-1), torch.cat(keep, dim=-1)


def _one_hot_slots(slots, values, e: int, cap: int):
    """(G, g, E, C) with ``values[..., i]`` at each token's slot
    ``slots[..., i]`` (``expert * C + position``) and zeros elsewhere: the
    reference's sum over choices of ``one_hot(pos, C) * keep`` (times the
    gate), exact, since a token's choices hold distinct experts."""
    n_groups, g, _ = slots.shape
    out = torch.zeros((n_groups, g, e * cap), dtype=values.dtype, device=slots.device)
    return out.scatter_(2, slots, values).view(n_groups, g, e, cap)


class _Dispatch(torch.autograd.Function):
    """``einsum("gtec,gtd->gecd", dispatch, xg)`` with the 0/1 dispatch
    tensor built from the slots in the forward and again in the backward,
    so that autograd keeps only the (G, g, k) slots and keeps."""

    @staticmethod
    def forward(ctx, xg, slots, keep, e: int, cap: int):
        ctx.save_for_backward(slots, keep)
        ctx.e, ctx.cap = e, cap
        return torch.einsum("gtec,gtd->gecd", _one_hot_slots(slots, keep.to(xg.dtype), e, cap), xg)

    @staticmethod
    def backward(ctx, d_in):
        slots, keep = ctx.saved_tensors
        dispatch = _one_hot_slots(slots, keep.to(d_in.dtype), ctx.e, ctx.cap)
        return torch.einsum("gtec,gecd->gtd", dispatch, d_in), None, None, None, None


class _Combine(torch.autograd.Function):
    """``einsum("gtec,gecd->gtd", combine, eout)`` with the gate-weighted
    combine tensor built from the slots in the forward and again in the
    backward; a gate's gradient is ``keep * <dout_t, eout[slot]>``, the
    one term of the reference's ``sum_ec d_combine * one_hot``."""

    @staticmethod
    def forward(ctx, gates, eout, slots, keep):
        n_groups, e, cap, _ = eout.shape
        ctx.save_for_backward(gates, eout, slots, keep)
        combine = _one_hot_slots(slots, gates * keep.to(gates.dtype), e, cap)
        return torch.einsum("gtec,gecd->gtd", combine, eout)

    @staticmethod
    def backward(ctx, dout):
        gates, eout, slots, keep = ctx.saved_tensors
        n_groups, e, cap, d = eout.shape
        d_gates = d_eout = None
        if ctx.needs_input_grad[1]:
            combine = _one_hot_slots(slots, gates * keep.to(gates.dtype), e, cap)
            d_eout = torch.einsum("gtec,gtd->gecd", combine, dout)
        if ctx.needs_input_grad[0]:
            picked = _take_rows(eout.reshape(n_groups, e * cap, d), slots.reshape(n_groups, -1))
            picked = picked.view(*slots.shape, d)  # (G, g, k, d)
            d_gates = torch.einsum("gtd,gtkd->gtk", dout, picked) * keep.to(dout.dtype)
        return d_gates, d_eout, None, None


def _take_rows(src, idx):
    """src (G, n, d), idx (G, m) -> (G, m, d): each group's rows ``idx``."""
    n_groups, n, d = src.shape
    offsets = torch.arange(n_groups, device=idx.device)[:, None] * n
    return src.reshape(-1, d).index_select(0, (idx + offsets).reshape(-1)).view(n_groups, -1, d)


def _with_zero_row(t):
    """(G, n, d) -> (G, n + 1, d): a zero row appended to each group."""
    return torch.cat([t, t.new_zeros((t.shape[0], 1, t.shape[2]))], dim=1)


class _GatherTokens(torch.autograd.Function):
    """The gather dispatch's ``take_along_axis``: each slot's token (the
    table's index ``g``, an empty slot, is the zero row).  Its backward
    gathers each token's slots and sums them in choice order, where the
    gather's own backward would add them by atomics on the card."""

    @staticmethod
    def forward(ctx, xg, table, slots):
        ctx.save_for_backward(slots)
        return _take_rows(_with_zero_row(xg), table)

    @staticmethod
    def backward(ctx, d_in):
        (slots,) = ctx.saved_tensors  # (G, g, k), a dropped choice parked on the zero row
        d_pad = _with_zero_row(d_in)
        dx = _take_rows(d_pad, slots[..., 0])
        for i in range(1, slots.shape[-1]):
            dx = dx + _take_rows(d_pad, slots[..., i])
        return dx, None, None


def moe_apply(params, cfg, x, group_size: Optional[int] = None, dispatch_mode: Optional[str] = None,
              devices: Optional[int] = None):
    """x: (B, S, d) -> (out (B, S, d) in ``x.dtype``, aux loss float32).

    ``devices`` N: x holds N devices' rows, device-major, and each device's
    tokens are routed as ``moe_apply`` routes them alone; the aux loss is
    then (N,), one per device."""
    dispatch_mode = dispatch_mode or cfg.moe_dispatch
    if dispatch_mode not in DISPATCH_MODES:
        raise ValueError(f"unknown dispatch_mode {dispatch_mode!r}")
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    tokens = x.reshape(-1, d)
    n_dev = devices or 1
    t = tokens.shape[0] // n_dev  # one device's tokens
    if t <= _WEIGHT_GATHER_MAX_TOKENS and dispatch_mode != "einsum_forced":
        out = _moe_weight_gather(params, cfg, x)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return out, aux if devices is None else aux.expand(devices)
    g = group_size or min(t, _DEFAULT_GROUP)
    if t % g:
        g = t  # one group for odd token counts, as the JAX package does
    n_groups = n_dev * (t // g)
    xg = tokens.reshape(n_groups, g, d)
    cap = min(int(max(k, g / e * cfg.capacity_factor * k)), g)
    gates, first, probs, expert, pos, keep = _route(params, cfg, xg, cap)

    # load-balance aux loss over the first choice (Switch convention)
    per_group = torch.sum(torch.mean(first, dim=1) * torch.mean(probs, dim=1), dim=-1)  # (G,)
    aux = e * (torch.mean(per_group) if devices is None else torch.mean(per_group.view(n_dev, -1), dim=1))

    if dispatch_mode == "gather":
        n_slots = e * cap
        slots = torch.where(keep, expert * cap + pos, n_slots)  # overflow parked on the zero row
        with torch.no_grad():
            table = torch.full((n_groups, n_slots + 1), g, dtype=torch.int64, device=x.device)  # g: the zero row
            tok_ids = torch.arange(g, device=x.device).expand(n_groups, g)
            for i in range(k):
                table.scatter_(1, slots[..., i], tok_ids)
            table = table[:, :n_slots]
        expert_in = _GatherTokens.apply(xg, table, slots)  # (G, E*C, d)
    else:
        slots = expert * cap + torch.where(keep, pos, 0)  # a dropped choice writes 0 into its own expert's row
        expert_in = _Dispatch.apply(xg, slots, keep, e, cap)  # (G, E, C, d)
    # groups folded into each expert's token axis: one (E, G*C, d) product per projection
    ein = expert_in.reshape(n_groups, e, cap, d).permute(1, 0, 2, 3).reshape(e, n_groups * cap, d)
    eout = _expert_ffn(params["experts"], ein)
    eout = eout.reshape(e, n_groups, cap, d).permute(1, 0, 2, 3)  # (G, E, C, d)
    if dispatch_mode == "gather":
        eout_pad = _with_zero_row(eout.reshape(n_groups, n_slots, d))
        out = torch.zeros((n_groups, g, d), dtype=x.dtype, device=x.device)
        for i in range(k):
            out = out + gates[..., i].to(x.dtype)[..., None] * _take_rows(eout_pad, slots[..., i])
    else:
        out = _Combine.apply(gates.to(x.dtype), eout, slots, keep)
    out = out.reshape(b, s, d)
    if "shared" in params:
        out = out + mlp_apply(params["shared"], cfg, x)
    return out, aux


def _moe_weight_gather(params, cfg, x):
    """The decode-time MoE of ``repro.nn.moe._moe_weight_gather``: each
    token through exactly its top-k experts.  x: (B, S, d) with B * S at
    most ``_WEIGHT_GATHER_MAX_TOKENS``; returns (B, S, d) in ``x.dtype``.

    The routing is the reference's: a float32 softmax, top-k, the gates
    renormalised and cast to ``x.dtype``, ``out += gate_i * y_i`` for
    choices i = 0 .. k-1, then the shared expert.  The reference gathers a
    (t, d, ff) copy of the chosen weights per choice (~2.8 GB at jamba's
    width); here each expert that any token chose runs once, on every
    token, with that expert's weight views (one host read of the routing a
    layer), and each choice picks its tokens' rows: only the routed
    experts' weights are read, none is copied, and a token's output does not
    depend on which experts the other tokens chose.

    On the ``meta`` device (the dry run) the routing cannot be read: every
    expert runs on every token, the upper bound of the work and memory."""
    b, s, d = x.shape
    xt = x.reshape(-1, d)
    logits = (xt @ params["router"]["w"].to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)  # (t, E)
    top_p, top_idx = torch.topk(probs, cfg.top_k, dim=-1)  # (t, k), descending
    gates = (top_p / (torch.sum(top_p, dim=-1, keepdim=True) + 1e-9)).to(x.dtype)
    if x.device.type == "meta":
        meta_upper_bounds["weight_gather"] += 1
        experts, which = list(range(cfg.num_experts)), top_idx
    else:
        routed = top_idx.cpu()
        chosen = torch.unique(routed)  # sorted
        # (t, k): each choice's row of ys
        experts, which = chosen.tolist(), torch.searchsorted(chosen, routed).to(x.device)
    ys = torch.stack([
        _expert_ffn({name: {key: v[e : e + 1] for key, v in node.items()} for name, node in params["experts"].items()},
                    xt[None])[0]
        for e in experts
    ])  # (U, t, d)
    rows = torch.arange(xt.shape[0], device=x.device)
    out = torch.zeros_like(xt)
    for i in range(cfg.top_k):
        out = out + gates[:, i, None] * ys[which[:, i], rows]
    out = out.reshape(b, s, d)
    if "shared" in params:
        out = out + mlp_apply(params["shared"], cfg, x)
    return out
