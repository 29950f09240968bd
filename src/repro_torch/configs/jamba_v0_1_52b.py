"""jamba-v0.1-52b — hybrid Mamba+attention 1:7 interleave with MoE.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16e top-2.
Attention at layer l % 8 == 4 (1 attention : 7 mamba), MoE every other
layer; no rotary embedding (Mamba carries position).  [arXiv:2403.19887]
"""
from repro_torch.configs.base import MambaConfig, ModelConfig

ARCH_ID = "jamba-v0.1-52b"

FULL = ModelConfig(
    name=ARCH_ID,
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    num_experts=16,
    top_k=2,
    moe_every=2,
    moe_offset=1,
    attn_every=8,
    attn_offset=4,
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    rope_theta=0.0,
    max_seq_len=524_288,
)

SMOKE = ModelConfig(
    name=ARCH_ID + "-smoke",
    family="hybrid",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    num_experts=4,
    top_k=2,
    moe_every=2,
    moe_offset=1,
    attn_every=2,
    attn_offset=1,
    mamba=MambaConfig(d_state=8, d_conv=4, expand=2),
    rope_theta=0.0,
    max_seq_len=512,
)
