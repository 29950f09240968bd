"""RMSNorm, and the LayerNorm of a GELU config (``activation="gelu"``),
both computed in float32 and cast back to the input dtype."""
from __future__ import annotations

import torch


def init_rmsnorm(dim: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def init_layernorm(dim: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


def apply_rmsnorm(params, x, eps: float = 1e-5):
    orig = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * params["scale"].float()).to(orig)


def apply_layernorm(params, x, eps: float = 1e-5):
    orig = x.dtype
    x = x.float()
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    x = (x - mean) * torch.rsqrt(var + eps)
    return (x * params["scale"].float() + params["bias"].float()).to(orig)


def apply_norm(params, x, eps: float = 1e-5):
    """A layer's or the final norm: LayerNorm where it has a ``bias``."""
    return apply_layernorm(params, x, eps) if "bias" in params else apply_rmsnorm(params, x, eps)
