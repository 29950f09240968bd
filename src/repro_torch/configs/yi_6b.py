"""yi-6b — dense llama-arch GQA decoder.

32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.  [arXiv:2403.04652]
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "yi-6b"

FULL = ModelConfig(
    name=ARCH_ID,
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    d_ff=11008,
    vocab_size=64_000,
    rope_theta=5_000_000.0,
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
    rope_theta=5_000_000.0,
    max_seq_len=512,
)
