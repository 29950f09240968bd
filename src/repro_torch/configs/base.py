"""Model and PEFT configuration for the PyTorch port.

A copy of the fields of ``repro.configs.base`` that the serving, the
local-training and the federated slices read (the dense family, the
``ssm`` family of RWKV6, the ``hybrid`` family of jamba, the ``moe``
family of granite-moe and llama4-scout, the ``audio`` encoder-decoder of
whisper and the ``vlm`` patch prefix of internvl2).  The port keeps its own copy so
that it never imports the JAX package; the field names, defaults and
meanings are the same.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class MambaConfig:
    """Selective-SSM (Mamba) block hyper-parameters (used by hybrid archs)."""

    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)

    def resolved_dt_rank(self, d_model: int) -> int:
        return self.dt_rank if self.dt_rank > 0 else max(1, -(-d_model // 16))


@dataclass(frozen=True)
class RWKVConfig:
    """RWKV6 ("Finch") block hyper-parameters."""

    head_dim: int = 64
    decay_lora_dim: int = 64
    gate_lora_dim: int = 128
    token_shift_lora_dim: int = 32


@dataclass(frozen=True)
class ModelConfig:
    """Model description: ``family`` is ``dense`` (attention layers),
    ``ssm`` (RWKV6 layers), ``hybrid`` (Mamba and attention layers, MoE
    every ``moe_every`` layers), ``moe`` (attention and MoE in every
    layer), ``audio`` (an encoder-decoder whose decoder layers
    cross-attend to the encoder's output; ``num_layers`` counts the
    decoder's) or ``vlm`` (a dense decoder behind a prefix of
    ``frontend_seq`` patch embeddings), as in the JAX package."""

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

    num_experts: int = 0
    top_k: int = 0
    moe_every: int = 1  # a layer l hosts MoE iff l % moe_every == moe_offset
    moe_offset: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    shared_expert: bool = False
    moe_dispatch: str = "einsum"  # einsum (GShard one-hot) | gather (permutation)

    attn_every: int = 0  # 0 = every layer is attention
    attn_offset: int = 0  # jamba: attention at l % attn_every == attn_offset
    mamba: Optional[MambaConfig] = None

    rwkv: Optional[RWKVConfig] = None

    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    modality: str = "text"  # text | audio | vision
    frontend_seq: int = 0  # frames (audio) or patches (vision) given by the stub frontend

    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    max_seq_len: int = 8192
    activation: str = "silu"  # silu (SwiGLU) | gelu (a biased up/down MLP)
    dtype: str = "bfloat16"  # activation/compute dtype
    param_dtype: str = "float32"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim > 0 else self.d_model // self.num_heads

    def is_attention_layer(self, l: int) -> bool:
        if self.attn_every <= 0:
            return True
        return l % self.attn_every == self.attn_offset

    def is_moe_layer(self, l: int) -> bool:
        if self.num_experts <= 0:
            return False
        return l % self.moe_every == self.moe_offset

    @property
    def layer_period(self) -> int:
        """Smallest period after which the layer pattern repeats."""
        p = 1
        if self.attn_every > 0:
            p = math.lcm(p, self.attn_every)
        if self.num_experts > 0:
            p = math.lcm(p, self.moe_every)
        return p

    @property
    def frontend_key(self) -> Optional[str]:
        """The stub frontend's batch key: ``frames`` (audio), ``patches``
        (vision), None (text)."""
        return {"audio": "frames", "vision": "patches"}.get(self.modality)

    @property
    def prefix_len(self) -> int:
        """Positions (and cache slots) that a vision model's patch prefix
        takes before the tokens; 0 for every other modality."""
        return self.frontend_seq if self.modality == "vision" else 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_counts(self) -> dict:
        """Analytic parameter counts (total, active under MoE top-k,
        embedding) for the system model, as the reference counts them: an
        encoder-decoder adds its encoder layers and the decoder's
        cross-attention."""
        d, hd = self.d_model, self.resolved_head_dim
        h, kv, ff = self.num_heads, self.num_kv_heads, self.d_ff
        attn = d * (h * hd) + 2 * d * (kv * hd) + (h * hd) * d
        mlp = 3 * d * ff if self.activation == "silu" else 2 * d * ff
        norms = 2 * d
        mamba_p = 0
        if self.mamba is not None:
            m = self.mamba
            d_in = m.expand * d
            dtr = m.resolved_dt_rank(d)
            mamba_p = (d * 2 * d_in + d_in * m.d_conv + d_in * (dtr + 2 * m.d_state) + dtr * d_in
                       + d_in * m.d_state + d_in + d_in * d)
        rwkv_p = 0
        if self.rwkv is not None:
            r = self.rwkv
            rwkv_p = (4 * d * d + d * r.gate_lora_dim + r.gate_lora_dim * d + d * r.decay_lora_dim
                      + r.decay_lora_dim * d + 2 * (d * r.token_shift_lora_dim * 5) + (d * ff + ff * d + d * d))
        total = active = 0
        for l in range(self.num_layers):
            if self.family == "ssm":
                layer_tot = layer_act = rwkv_p + norms
            elif self.is_attention_layer(l):
                layer_tot = layer_act = attn + norms
            else:
                layer_tot = layer_act = mamba_p + norms
            if self.family != "ssm":
                if self.is_moe_layer(l):
                    layer_tot += self.num_experts * mlp + d * self.num_experts
                    layer_act += max(self.top_k, 1) * mlp + d * self.num_experts
                    if self.shared_expert:
                        layer_tot += mlp
                        layer_act += mlp
                else:
                    layer_tot += mlp
                    layer_act += mlp
            total += layer_tot
            active += layer_act
        emb = self.vocab_size * d
        head = emb + d + (0 if self.tie_embeddings else emb)
        total, active = total + head, active + head
        if self.is_encoder_decoder:
            extra = self.num_encoder_layers * (attn + mlp + norms) + self.num_layers * attn
            total, active = total + extra, active + extra
        return {"total": total, "active": active, "embedding": emb}


@dataclass(frozen=True)
class InputShape:
    """One of the four assigned workload shapes."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class PEFTConfig:
    """Parameter-efficient fine-tuning configuration (paper §2.2)."""

    method: str = "lora"        # lora | adapter | bitfit | none
    lora_rank: int = 8
    lora_alpha: float = 16.0
    lora_targets: tuple = ("q", "v")  # which projections get LoRA
    adapter_dim: int = 64


@dataclass(frozen=True)
class STLDConfig:
    """Stochastic transformer layer dropout (paper §3.2-3.3).  ``cond``
    draws a Bernoulli gate per layer; ``gather`` a fixed count of active
    layers a round (Gumbel top-k).  Either way a dropped layer is skipped by
    a host-side branch."""

    enabled: bool = True
    mode: str = "cond"            # cond (paper-faithful) | gather (static active count)
    distribution: str = "incremental"  # uniform | decay | incremental | normal
    mean_rate: float = 0.5
    normal_std: float = 0.1
    min_active_layers: int = 1
    # gather mode: static active count = round(L * (1 - mean_rate)), bucketed
    gather_bucket: int = 4


@dataclass(frozen=True)
class FederatedConfig:
    """Federated fine-tuning round configuration (paper §6.1)."""

    num_devices: int = 100
    devices_per_round: int = 10
    local_epochs: int = 1
    local_steps: int = 4
    batch_size: int = 16
    rounds: int = 100
    dirichlet_alpha: float = 1.0
    target_accuracy: float = 0.9
    # PTLS
    ptls_enabled: bool = True
    ptls_share_fraction: float = 0.5  # k = fraction * L layers shared
    # bandit configurator
    configurator_enabled: bool = True
    explore_rate: float = 0.3
    explore_interval: int = 5
    num_candidates: int = 4
    window_size: int = 8
    rate_grid: tuple = (0.0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9)
    seed: int = 0


@dataclass(frozen=True)
class TrainConfig:
    """Optimizer and learning-rate schedule."""

    learning_rate: float = 2e-4
    weight_decay: float = 0.01
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 20
    schedule: str = "cosine"  # cosine | linear | constant
    total_steps: int = 1000


@dataclass(frozen=True)
class RunConfig:
    """Top-level bundle handed to launchers."""

    model: ModelConfig
    peft: PEFTConfig = field(default_factory=PEFTConfig)
    stld: STLDConfig = field(default_factory=STLDConfig)
    federated: FederatedConfig = field(default_factory=FederatedConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
