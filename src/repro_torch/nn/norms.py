"""RMSNorm (computed in float32, cast back to the input dtype)."""
from __future__ import annotations

import torch


def apply_rmsnorm(params, x, eps: float = 1e-5):
    orig = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * params["scale"].float()).to(orig)
