"""granite-moe-3b-a800m — fine-grained MoE, 40 experts top-8, tiny experts.

32L d_model=1536 24H (GQA kv=8) d_ff=512 vocab=49155, MoE 40e top-8 in
every layer.  [hf:ibm-granite/granite-3.0-1b-a400m-base]
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "granite-moe-3b-a800m"

FULL = ModelConfig(
    name=ARCH_ID,
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49_155,
    num_experts=40,
    top_k=8,
    moe_every=1,
    rope_theta=10_000.0,
    max_seq_len=4096,
)

SMOKE = ModelConfig(
    name=ARCH_ID + "-smoke",
    family="moe",
    num_layers=2,
    d_model=96,
    num_heads=4,
    num_kv_heads=2,
    d_ff=64,
    vocab_size=512,
    num_experts=4,
    top_k=2,
    moe_every=1,
    rope_theta=10_000.0,
    max_seq_len=512,
)
