"""Serving of the port: multi-tenant LoRA adapter pools, the continuous
batcher, the decode loop and the sequence-sharded decode attention."""
from repro_torch.serving.adapters import AdapterPoolCache, AdapterRegistry
from repro_torch.serving.batcher import Completion, ContinuousBatcher, Request, batched_caches
from repro_torch.serving.decode import generate, sharded_decode_attention

__all__ = [
    "AdapterPoolCache",
    "AdapterRegistry",
    "Completion",
    "ContinuousBatcher",
    "Request",
    "batched_caches",
    "generate",
    "sharded_decode_attention",
]
