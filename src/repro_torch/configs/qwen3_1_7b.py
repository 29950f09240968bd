"""qwen3-1.7b — dense decoder with qk-norm and GQA.

28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936.  [hf:Qwen/Qwen3-8B]
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "qwen3-1.7b"

FULL = ModelConfig(
    name=ARCH_ID,
    family="dense",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=6144,
    vocab_size=151_936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    max_seq_len=32_768,
)

SMOKE = ModelConfig(
    name=ARCH_ID + "-smoke",
    family="dense",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    max_seq_len=512,
)
