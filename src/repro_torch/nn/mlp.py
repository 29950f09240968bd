"""Feed-forward blocks: SwiGLU (the llama family of qwen3) and GELU (biased
``up`` and ``down``), and the bottleneck adapter of the PEFT ``adapter``
method, as ``repro.nn.mlp``.

GELU is the tanh approximation: ``jax.nn.gelu``'s default, where
``torch.nn.functional.gelu`` defaults to the exact erf form.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.nn.initializers import truncated_lecun
from repro_torch.nn.linear import apply_linear
from repro_torch.sharding.collectives import Shard


def gelu(x):
    """``jax.nn.gelu`` (``approximate=True``, its default)."""
    return F.gelu(x, approximate="tanh")


def init_mlp(cfg, generator: torch.Generator, d_ff: Optional[int] = None, lead: tuple = (), place=None):
    """A per-layer MLP (float32): SwiGLU ``gate``/``up``/``down`` when
    ``cfg.activation`` is ``silu``, else GELU's biased ``up`` and ``down``.
    ``lead`` is a leading ``(L,)`` layer axis for a stacked tree;
    ``place(proj)``, when given, takes each projection as soon as it is
    drawn and returns what to keep."""
    d, ff = cfg.d_model, d_ff or cfg.d_ff

    def linear(d_in, d_out, bias=False):
        p = {"w": truncated_lecun(generator, (*lead, d_in, d_out), fan_in_axis=len(lead))}
        if bias:
            p["b"] = torch.zeros((*lead, d_out), device=generator.device)
        return place(p) if place is not None else p

    if cfg.activation == "silu":
        return {"gate": linear(d, ff), "up": linear(d, ff), "down": linear(ff, d)}
    return {"up": linear(d, ff, bias=True), "down": linear(ff, d, bias=True)}


def mlp_apply(params, cfg, x, peft: Optional[dict] = None, lora_scale: float = 1.0, tp=None):
    """The MLP of ``x``.  ``tp`` (a ``sharding.collectives.Comm``) runs the
    rank's part of a tensor-parallel step: ``gate`` and ``up``
    column-parallel over its ``d_ff / tp`` columns, ``down`` row-parallel
    over the same rows."""
    peft = peft or {}
    sc = sr = None
    if tp is not None:
        x = tp.enter(x)
        sc = Shard(tp, "col", *tp.cols(params["up"]["w"].shape[-1] * tp.tp))
        sr = Shard(tp, "row", sc.lo, sc.hi)
    if "gate" in params:
        g = apply_linear(params["gate"], x, peft.get("gate"), lora_scale, shard=sc)
        u = apply_linear(params["up"], x, peft.get("up"), lora_scale, shard=sc)
        h = F.silu(g) * u
    else:
        h = gelu(apply_linear(params["up"], x, peft.get("up"), lora_scale, shard=sc))
    return apply_linear(params["down"], h, peft.get("down"), lora_scale, shard=sr)


# ----------------------------------------------------------------- adapters
def init_adapter(generator: torch.Generator, d_model: int, adapter_dim: int, lead: tuple = ()):
    """Houlsby bottleneck adapter: ``down`` LeCun-truncated with fan-in
    ``d_model``, ``up`` zero, so a fresh adapter is an identity residual.
    ``lead`` is a leading ``(L,)`` layer axis for a stacked tree."""
    return {
        "down": {"w": truncated_lecun(generator, (*lead, d_model, adapter_dim), fan_in_axis=len(lead))},
        "up": {"w": torch.zeros((*lead, adapter_dim, d_model), device=generator.device)},
    }


def _device_product(x, w, devices: Optional[int]):
    """``x @ w``; for a cohort (``devices`` N, ``w`` (N, in, out)) each
    device's equal row block of ``x`` times its own ``w``."""
    w = w.to(x.dtype)
    if devices is None or w.ndim == 2:
        return x @ w
    xd = x.reshape(devices, -1, x.shape[-1])
    return torch.bmm(xd, w).reshape(*x.shape[:-1], w.shape[-1])


def adapter_apply(params, x, devices: Optional[int] = None):
    """``x + up(gelu(down(x)))``.  ``devices`` N: ``x`` folds N devices'
    equal row blocks and each ``w`` is ``(N, in, out)``, one adapter a
    device."""
    h = gelu(_device_product(x, params["down"]["w"], devices))
    return x + _device_product(h, params["up"]["w"], devices)
