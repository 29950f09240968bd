"""h2o-danube-1.8b — llama+mistral mix with sliding-window attention.

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000, SWA window 4096.
[arXiv:2401.16818]
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "h2o-danube-1.8b"

FULL = ModelConfig(
    name=ARCH_ID,
    family="dense",
    num_layers=24,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6912,
    vocab_size=32_000,
    sliding_window=4096,
    rope_theta=10_000.0,
    max_seq_len=524_288,   # SWA -> O(window) decode cache; long-context capable
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
    sliding_window=64,
    rope_theta=10_000.0,
    max_seq_len=512,
)
