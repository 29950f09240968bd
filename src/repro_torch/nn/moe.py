"""Mixture of experts with GShard-style capacity dispatch, as
``repro.nn.moe`` in its default ``einsum`` dispatch.

Tokens (B, S, d) are cut into groups of at most 4 096; per group a top-k
router (softmax in float32, iterative argmax, gates renormalised over the
chosen experts) gives each token a position in each chosen expert's queue
of ``capacity`` slots (overflow is dropped), and one-hot dispatch and
combine tensors move the tokens through the experts.  The experts' MLP
products are ``(E, groups * capacity, d)`` batched matmuls, which the JAX
package also leaves to XLA outside any Pallas kernel.  The aux loss is the
Switch load-balance loss over the first choice.  A cohort (``devices``)
folds its devices' equal token blocks into the batch: the groups are cut
from one device's tokens, so no group spans two devices and each device
keeps its own capacity and drops, and the aux loss comes back per device.

At most ``_WEIGHT_GATHER_MAX_TOKENS`` tokens (a decode step) take the
reference's weight gather instead (``_moe_weight_gather``), unless the
dispatch is ``einsum_forced``.  Not ported yet, and raising: the
``gather`` dispatch and the shared expert.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.nn.initializers import truncated_lecun
from repro_torch.nn.mlp import gelu, init_mlp

_DEFAULT_GROUP = 4096
_WEIGHT_GATHER_MAX_TOKENS = 8  # repro/nn/moe.py: at or below, decode gathers expert weights


def init_moe(cfg, generator: torch.Generator):
    """One layer's router and stacked experts (float32, SwiGLU or GELU as
    ``cfg.activation`` says), with the shapes of
    ``repro.nn.moe.init_moe``, drawn on the generator's device."""
    if cfg.shared_expert:
        raise NotImplementedError("the shared expert is not ported")
    router = {"w": truncated_lecun(generator, (cfg.d_model, cfg.num_experts))}
    return {"router": router, "experts": init_mlp(cfg, generator, lead=(cfg.num_experts,))}


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


def _one_hot(values, n: int, dtype):
    """``jax.nn.one_hot`` of integral values: rows outside [0, n) are zero."""
    return (values[..., None] == torch.arange(n, device=values.device, dtype=values.dtype)).to(dtype)


def moe_apply(params, cfg, x, group_size: Optional[int] = None, dispatch_mode: Optional[str] = None,
              devices: Optional[int] = None):
    """x: (B, S, d) -> (out (B, S, d) in ``x.dtype``, aux loss float32).

    ``devices`` N: x holds N devices' rows, device-major, and each device's
    tokens are routed as ``moe_apply`` routes them alone; the aux loss is
    then (N,), one per device."""
    dispatch_mode = dispatch_mode or cfg.moe_dispatch
    if "shared" in params:
        raise NotImplementedError("the shared expert is not ported")
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    tokens = x.reshape(-1, d)
    n_dev = devices or 1
    t = tokens.shape[0] // n_dev  # one device's tokens
    if t <= _WEIGHT_GATHER_MAX_TOKENS and dispatch_mode != "einsum_forced":
        out = _moe_weight_gather(params, cfg, x)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return out, aux if devices is None else aux.expand(devices)
    if dispatch_mode not in ("einsum", "einsum_forced"):
        raise NotImplementedError(f"MoE dispatch {dispatch_mode!r} is not ported; the port runs 'einsum'")
    g = group_size or min(t, _DEFAULT_GROUP)
    if t % g:
        g = t  # one group for odd token counts, as the JAX package does
    n_groups = n_dev * (t // g)
    xg = tokens.reshape(n_groups, g, d)
    cap = min(int(max(k, g / e * cfg.capacity_factor * k)), g)

    logits = torch.einsum("gtd,de->gte", xg, params["router"]["w"].to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)  # (G, g, E)

    # top-k routing: take the argmax (first index on ties), mask it, repeat
    gates, masks = [], []
    remaining = probs
    for _ in range(k):
        onehot = F.one_hot(torch.argmax(remaining, dim=-1), e).to(probs.dtype)
        gates.append(torch.sum(probs * onehot, dim=-1))
        masks.append(onehot)
        remaining = remaining * (1.0 - onehot)
    gate_stack = torch.stack(gates, dim=-1)  # (G, g, k)
    gate_stack = gate_stack / (torch.sum(gate_stack, dim=-1, keepdim=True) + 1e-9)

    # load-balance aux loss over the first choice (Switch convention)
    frac_tokens = torch.mean(masks[0], dim=1)  # (G, E)
    mean_probs = torch.mean(probs, dim=1)
    per_group = torch.sum(frac_tokens * mean_probs, dim=-1)  # (G,)
    aux = e * (torch.mean(per_group) if devices is None else torch.mean(per_group.view(n_dev, -1), dim=1))

    # capacity: each token's position in its expert's queue, overflow dropped
    used = torch.zeros((n_groups, e), dtype=torch.int32, device=x.device)
    dispatch = torch.zeros((n_groups, g, e, cap), dtype=x.dtype, device=x.device)
    combine = torch.zeros_like(dispatch)
    for i in range(k):
        mask_i = masks[i]  # (G, g, E)
        pos_in_e = torch.cumsum(mask_i, dim=1) - mask_i + used[:, None, :]
        keep = (pos_in_e < cap) * mask_i
        used = used + torch.sum(keep, dim=1).to(torch.int32)
        onehot_cap = _one_hot(pos_in_e, cap, x.dtype) * keep.to(x.dtype)[..., None]
        dispatch = dispatch + onehot_cap
        combine = combine + onehot_cap * gate_stack[..., i].to(x.dtype)[..., None, None]

    expert_in = torch.einsum("gtec,gtd->gecd", dispatch, xg)  # (G, E, C, d)
    # groups folded into each expert's token axis: one (E, G*C, d) product per projection
    ein = expert_in.permute(1, 0, 2, 3).reshape(e, n_groups * cap, d)
    eout = _expert_ffn(params["experts"], ein)
    eout = eout.reshape(e, n_groups, cap, d).permute(1, 0, 2, 3)
    out = torch.einsum("gtec,gecd->gtd", combine, eout).reshape(b, s, d)
    return out, aux


def _moe_weight_gather(params, cfg, x):
    """The decode-time MoE of ``repro.nn.moe._moe_weight_gather``: each
    token through exactly its top-k experts.  x: (B, S, d) with B * S at
    most ``_WEIGHT_GATHER_MAX_TOKENS``; returns (B, S, d) in ``x.dtype``.

    The routing is the reference's: a float32 softmax, top-k, the gates
    renormalised and cast to ``x.dtype``, ``out += gate_i * y_i`` for
    choices i = 0 .. k-1.  The reference gathers a (t, d, ff) copy of the
    chosen weights per choice (~2.8 GB at jamba's width); here each choice
    groups its tokens by expert (one host read of the routing a layer) and
    runs ``_expert_ffn`` on them with that expert's weight views, so only
    the routed experts' weights are read and none is copied."""
    b, s, d = x.shape
    xt = x.reshape(-1, d)
    logits = (xt @ params["router"]["w"].to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)  # (t, E)
    top_p, top_idx = torch.topk(probs, cfg.top_k, dim=-1)  # (t, k), descending
    gates = (top_p / (torch.sum(top_p, dim=-1, keepdim=True) + 1e-9)).to(x.dtype)
    routed = top_idx.cpu()
    out = torch.zeros_like(xt)
    for i in range(cfg.top_k):
        y = torch.empty_like(xt)
        for e in torch.unique(routed[:, i]).tolist():
            rows = torch.nonzero(routed[:, i] == e)[:, 0].to(x.device)
            expert = {name: {k: v[e : e + 1] for k, v in node.items()} for name, node in params["experts"].items()}
            y.index_copy_(0, rows, _expert_ffn(expert, xt.index_select(0, rows)[None])[0])
        out = out + gates[:, i, None] * y
    return out.reshape(b, s, d)
