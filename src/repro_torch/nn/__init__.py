"""Layers of the port: every module an ``init_*`` / ``*_apply`` pair over
plain trees of tensors, as ``repro.nn`` (initializers draw from an explicit
``torch.Generator``).  Norms, rotary, linear (LoRA and adapter pools),
MLP, attention, RWKV6, Mamba and MoE."""
from repro_torch.nn.initializers import normal_init, truncated_lecun, zeros_init
from repro_torch.nn.linear import apply_linear, init_linear, lora_delta
from repro_torch.nn.norms import apply_layernorm, apply_rmsnorm, init_layernorm, init_rmsnorm
from repro_torch.nn.rotary import apply_rotary

__all__ = [
    "normal_init",
    "truncated_lecun",
    "zeros_init",
    "apply_linear",
    "init_linear",
    "lora_delta",
    "apply_layernorm",
    "apply_rmsnorm",
    "init_layernorm",
    "init_rmsnorm",
    "apply_rotary",
]
