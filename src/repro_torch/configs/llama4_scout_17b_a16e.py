"""llama4-scout-17b-a16e — MoE decoder (the text backbone of an early-fusion model).

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 16e top-1 plus
an always-on shared expert in every layer.  [hf:meta-llama/Llama-4-Scout-17B-16E]
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "llama4-scout-17b-a16e"

FULL = ModelConfig(
    name=ARCH_ID,
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202_048,
    num_experts=16,
    top_k=1,
    moe_every=1,
    shared_expert=True,  # top-1 routing plus the shared expert
    rope_theta=500_000.0,
    max_seq_len=131_072,
)

SMOKE = ModelConfig(
    name=ARCH_ID + "-smoke",
    family="moe",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    num_experts=4,
    top_k=1,
    moe_every=1,
    shared_expert=True,
    rope_theta=500_000.0,
    max_seq_len=512,
)
