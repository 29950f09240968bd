"""rwkv6-3b ("Finch") — attention-free RNN with data-dependent decay.

32L d_model=2560 d_ff=8960 vocab=65536.  [arXiv:2404.05892]
"""
from repro_torch.configs.base import ModelConfig, RWKVConfig

ARCH_ID = "rwkv6-3b"

FULL = ModelConfig(
    name=ARCH_ID,
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=40,            # 2560 / head_dim 64
    num_kv_heads=40,
    d_ff=8960,
    vocab_size=65536,
    rwkv=RWKVConfig(head_dim=64, decay_lora_dim=64, gate_lora_dim=160),
    max_seq_len=524_288,
)

SMOKE = ModelConfig(
    name=ARCH_ID + "-smoke",
    family="ssm",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    d_ff=256,
    vocab_size=512,
    rwkv=RWKVConfig(head_dim=32, decay_lora_dim=16, gate_lora_dim=32),
    max_seq_len=512,
)
