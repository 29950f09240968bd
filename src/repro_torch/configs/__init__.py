"""Architecture configs of the port.

``get_config(arch_id)`` returns the FULL configuration;
``get_config(arch_id, smoke=True)`` the reduced variant the CPU tests use.
"""
from repro_torch.configs import (
    glm4_9b, granite_moe_3b_a800m, h2o_danube_1_8b, internvl2_76b, jamba_v0_1_52b, llama4_scout_17b_a16e, qwen3_1_7b,
    rwkv6_3b, whisper_tiny, yi_6b,
)
from repro_torch.configs.base import (
    INPUT_SHAPES, FederatedConfig, InputShape, MambaConfig, ModelConfig, PEFTConfig, RunConfig, RWKVConfig, STLDConfig,
    TrainConfig,
)

# in the order of the reference's registry
_BY_ID = {m.ARCH_ID: m for m in (jamba_v0_1_52b, llama4_scout_17b_a16e, internvl2_76b, yi_6b, granite_moe_3b_a800m,
                                 rwkv6_3b, glm4_9b, qwen3_1_7b, h2o_danube_1_8b, whisper_tiny)}
ARCH_IDS = tuple(_BY_ID)  # the archs the port runs: all ten of the reference's

# (arch, shape) pairs excluded from long-context decode, with reasons, as
# the reference's skip matrix.  Everything else in ARCH_IDS x INPUT_SHAPES runs.
LONG_CONTEXT_SKIPS = {
    "llama4-scout-17b-a16e": "full global attention (chunked-RoPE variant not implemented)",
    "internvl2-76b": "full attention",
    "yi-6b": "full attention",
    "glm4-9b": "full attention",
    "qwen3-1.7b": "full attention",
    "granite-moe-3b-a800m": "full attention",
    "whisper-tiny": "full attention; decoder context out-of-family at 500k",
}


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    if arch_id not in _BY_ID:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_BY_ID)}")
    mod = _BY_ID[arch_id]
    return mod.SMOKE if smoke else mod.FULL


def shape_applicable(arch_id: str, shape_name: str) -> bool:
    """Whether an (arch, input-shape) cell runs (the skip matrix above)."""
    return not (shape_name == "long_500k" and arch_id in LONG_CONTEXT_SKIPS)


__all__ = [
    "ARCH_IDS", "INPUT_SHAPES", "LONG_CONTEXT_SKIPS", "FederatedConfig", "InputShape", "MambaConfig", "ModelConfig",
    "PEFTConfig", "RunConfig", "RWKVConfig", "STLDConfig", "TrainConfig", "get_config", "shape_applicable",
]
