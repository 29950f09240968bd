"""Model and PEFT configuration for the PyTorch port.

A copy of the fields of ``repro.configs.base`` that the serving slice
reads.  The port keeps its own copy so that it never imports the JAX
package; the field names, defaults and meanings are the same.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    """Dense decoder description (the ``dense`` family of the JAX package)."""

    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0  # 0 -> d_model // num_heads
    qk_norm: bool = False
    sliding_window: Optional[int] = None  # tokens; None = global attention
    rope_theta: float = 10_000.0
    attention_bias: bool = False

    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"  # activation/compute dtype
    param_dtype: str = "float32"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim > 0 else self.d_model // self.num_heads

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class PEFTConfig:
    """LoRA configuration (paper §2.2); the port has the LoRA method only."""

    lora_rank: int = 8
    lora_alpha: float = 16.0
    lora_targets: tuple = ("q", "v")
