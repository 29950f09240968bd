"""Entry points of the port.

``serve`` builds a ready multi-tenant LoRA server::

    from repro_torch import api
    from repro_torch.serving.batcher import Request

    batcher = api.serve(adapters={"client0": tree0, "client1": tree1}, batch=8)
    batcher.submit(Request(prompt=[5, 7, 11], adapter="client0", max_new_tokens=32))
    for c in batcher.run():  # Completion(uid, adapter, tokens, finish_reason)
        print(c.adapter, c.finish_reason, c.tokens)

Every entry point runs on the CUDA card unless the caller passes
``device="cpu"``; it never falls back to the CPU on its own.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs import get_config

__all__ = ["serve"]

def serve(
    model: str = "qwen3-1.7b",
    *,
    smoke: bool = True,
    cfg=None,
    params=None,
    adapters: Optional[dict] = None,
    lora_alpha: float = 16.0,
    batch: int = 4,
    max_len: int = 256,
    n_slots: Optional[int] = None,
    cache_dtype: str = "bfloat16",
    seed: int = 0,
    device=None,
):
    """Multi-tenant adapter serving: a ready
    :class:`~repro_torch.serving.batcher.ContinuousBatcher`.

    ``adapters`` is a ``{name: stacked LoRA tree}`` dict.  ``params=None``
    draws random weights from ``seed`` on the device.  The base weights are
    cast to ``cfg.dtype`` once here; the float32 masters are not kept.
    """
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models.registry import init_params, place_params
    from repro_torch.serving.adapters import AdapterPoolCache, AdapterRegistry
    from repro_torch.serving.batcher import ContinuousBatcher

    device = torch.device("cuda" if device is None else device)
    if cfg is None:
        cfg = get_config(model, smoke=smoke)
    registry = AdapterRegistry()
    for name, tree in (adapters or {}).items():
        registry.register(name, tree, alpha=lora_alpha)
    if len(registry) == 0:
        raise ValueError("no adapters: pass adapters={name: lora_tree}")
    compute_dtype = getattr(torch, cfg.dtype)
    if params is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
        params = init_params(cfg, generator)
    params = place_params(params, cfg, device)
    pool = AdapterPoolCache(
        registry,
        n_slots=n_slots if n_slots is not None else max(batch, len(registry)),
        dtype=compute_dtype,
        device=device,
    )
    return ContinuousBatcher(
        make_serve_step(cfg),
        params,
        cfg,
        pool,
        batch=batch,
        max_len=max_len,
        cache_dtype=getattr(torch, cache_dtype),
    )
