"""The serving step: one token per row against the batched KV cache."""
from __future__ import annotations

import torch

from repro_torch.models.transformer import lm_apply


def make_serve_step(cfg):
    """Single-token decode against the batched serving cache.

    ``(params, token (B, 1), pos (B,), caches, peft=None) ->
    (logits (B, V), next_token (B, 1) int32, caches)``: every row decodes at
    its own position; ``peft`` is a tree of per-projection
    :class:`~repro_torch.nn.linear.AdapterPool` nodes (or plain LoRA).
    The caches' K/V tensors are updated in place.
    """

    @torch.no_grad()
    def serve_step(params, token, pos, caches, peft=None):
        positions = pos[:, None]  # (B, 1)
        logits, caches = lm_apply(params, cfg, token, positions=positions, caches=caches, peft=peft)
        logits = logits[:, -1]
        next_token = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        return logits, next_token, caches

    return serve_step
