"""glm4-9b — dense decoder, RoPE, aggressive GQA (kv=2).

40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552.  [hf:THUDM/glm-4-9b]
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "glm4-9b"

FULL = ModelConfig(
    name=ARCH_ID,
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    d_ff=13696,
    vocab_size=151_552,
    rope_theta=10_000.0,
    attention_bias=True,   # glm4 uses qkv bias
    max_seq_len=131_072,
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
    rope_theta=10_000.0,
    attention_bias=True,
    max_seq_len=512,
)
