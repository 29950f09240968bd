"""Linear projection with optional bias and LoRA side-branch.

LoRA params for a projection are ``{"a": (in, r), "b": (r, out)}`` with the
runtime ``scale`` passed explicitly.  A LoRA projection runs through
``ops.lora_matmul`` (the main product and the rank-r branch in one kernel
on the card, its plain twin on the CPU), differentiable in x, a and b.  A
cohort's node holds one adapter per device, ``{"a": (G, in, r), "b": (G,
r, out)}``, and the leading axis of ``x`` folds the G devices' equal row
blocks in device order: the grouped kernel gives each block its own
adapter in the same one launch.  For multi-tenant serving a
projection's peft node can instead be an :class:`AdapterPool` (a stacked
pool of adapters plus a per-row slot map), and ``apply_linear`` then
dispatches to the segmented kernel, so every batch row applies its own
tenant's adapter in one launch.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.nn.initializers import truncated_lecun


@dataclass(frozen=True)
class AdapterPool:
    """Per-projection multi-tenant adapter pool riding inside a peft tree.

    ``a: (n_slots, d_in, r_max)`` and ``b: (n_slots, r_max, d_out)`` hold
    zero-padded adapters with the per-adapter scale (alpha/rank) folded
    into ``b`` at slot-write time; ``ranks: (n_slots,)`` is each slot's true
    rank for the in-kernel tail mask; ``idx: (batch,)`` maps each batch row
    to its slot.  In the stacked layout every field has a leading layer
    axis (``idx`` expanded to ``(L, batch)``), so ``stacking.layer_view``
    slices a pool like any other leaf.
    """

    a: torch.Tensor
    b: torch.Tensor
    idx: torch.Tensor
    ranks: torch.Tensor


def init_linear(generator: torch.Generator, d_in: int, d_out: int, bias: bool = False, dtype=torch.float32):
    """``{"w": (d_in, d_out)}`` (truncated LeCun), and a zero ``b`` with
    ``bias``, on the generator's device."""
    p = {"w": truncated_lecun(generator, (d_in, d_out), dtype=dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=generator.device)
    return p


def init_lora(generator: torch.Generator, d_in: int, d_out: int, rank: int, dtype=torch.float32, *, lead=()):
    """LoRA per Hu et al., as the reference's ``init_lora``: ``{"a": (d_in,
    r)}`` truncated LeCun and a zero ``{"b": (r, d_out)}`` (the delta
    starts at zero), on the generator's device.  ``lead`` (L,) draws L
    layers' adapters stacked."""
    return {
        "a": truncated_lecun(generator, (*lead, d_in, rank), fan_in_axis=len(lead), dtype=dtype),
        "b": torch.zeros((*lead, rank, d_out), dtype=dtype, device=generator.device),
    }


def lora_delta(x, lora, scale: float):
    """``scale * (x @ a) @ b``, the LoRA contribution alone (plain
    products; ``apply_linear`` fuses it with ``x @ w`` in one kernel)."""
    return scale * ((x @ lora["a"].to(x.dtype)) @ lora["b"].to(x.dtype))


def _pooled_linear(params, x, pool: AdapterPool, shard=None):
    """Segmented multi-adapter projection: row i applies adapter
    ``pool.idx[i]``; main product and gathered LoRA branch in one kernel.
    ``shard`` as ``apply_linear``'s: the pool's ``b`` cut to the rank's
    columns (``col``), or its ``a`` to the rank's rows and the output
    summed over ``model`` (``row``)."""
    w = params["w"].to(x.dtype)
    bias = params.get("b")
    lead = x.shape[:-1]
    xm = x.reshape(-1, x.shape[-1]).contiguous()
    idx = pool.idx
    if x.ndim == 3 and x.shape[1] != 1:
        idx = torch.repeat_interleave(idx, x.shape[1])  # every token of a row shares its adapter
    a, b = pool.a, pool.b
    if shard is not None and shard.kind == "col":
        b = b[..., shard.lo:shard.hi]
        bias = None if bias is None else bias[..., shard.lo:shard.hi]
    elif shard is not None:
        a = a[..., shard.lo:shard.hi, :]
    y = ops.segmented_lora(xm, w, a.to(x.dtype).contiguous(), b.to(x.dtype).contiguous(), idx.contiguous(),
                           pool.ranks)
    y = y.reshape(*lead, w.shape[-1])
    if shard is not None and shard.kind == "row":
        y = shard.comm.reduce(y)
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


def apply_linear(params, x, lora: Optional[dict] = None, lora_scale: float = 1.0, *, shard=None):
    """``x @ w`` (plus the LoRA branch, plus the bias).

    ``shard`` (a ``sharding.collectives.Shard``) runs the projection
    tensor-parallel over ``model``, ``params["w"]`` being this rank's part
    and the bias and the LoRA whole (replicated): ``col``, the rank's output
    columns ``lo:hi`` (B's and the bias's columns cut alike); ``row``, its
    input rows ``lo:hi`` of ``x``'s features (A's rows cut alike, B whole),
    the output summed over ``model`` (the LoRA term with the product) and
    the bias added once after the sum; an :class:`AdapterPool` is cut
    alike (``_pooled_linear``)."""
    if isinstance(lora, AdapterPool):
        return _pooled_linear(params, x, lora, shard)
    w = params["w"].to(x.dtype)
    bias = params.get("b")
    if shard is not None and lora is not None:
        if shard.kind == "col":
            lora = {"a": lora["a"], "b": lora["b"][..., shard.lo:shard.hi].contiguous()}
        else:
            lora = {"a": lora["a"][..., shard.lo:shard.hi, :], "b": lora["b"]}
    if shard is not None and shard.kind == "col" and bias is not None:
        bias = bias[..., shard.lo:shard.hi]
    if lora is None:
        y = x @ w
    else:
        xm = x.reshape(-1, x.shape[-1]).contiguous()
        y = ops.lora_matmul(xm, w, lora["a"].to(x.dtype), lora["b"].to(x.dtype), alpha=lora_scale)
        y = y.reshape(*x.shape[:-1], w.shape[-1])
    if shard is not None and shard.kind == "row":
        y = shard.comm.reduce(y)
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y
