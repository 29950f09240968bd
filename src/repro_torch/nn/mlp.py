"""SwiGLU feed-forward block (the llama-family MLP of qwen3)."""
from __future__ import annotations

from typing import Optional

import torch.nn.functional as F

from repro_torch.nn.linear import apply_linear


def mlp_apply(params, cfg, x, peft: Optional[dict] = None, lora_scale: float = 1.0):
    peft = peft or {}
    g = apply_linear(params["gate"], x, peft.get("gate"), lora_scale)
    u = apply_linear(params["up"], x, peft.get("up"), lora_scale)
    return apply_linear(params["down"], F.silu(g) * u, peft.get("down"), lora_scale)
