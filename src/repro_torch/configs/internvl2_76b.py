"""internvl2-76b — VLM: InternViT (stub frontend) + InternLM2-76B backbone.

80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.  The vision
encoder and its MLP projector are a stub: the model takes pre-projected
patch embeddings as a prefix.  [arXiv:2404.16821]
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "internvl2-76b"

FULL = ModelConfig(
    name=ARCH_ID,
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128_256,
    modality="vision",
    frontend_seq=256,  # 256 patch embeddings an image (448 px, pixel shuffle)
    rope_theta=1_000_000.0,
    max_seq_len=32_768,
)

SMOKE = ModelConfig(
    name=ARCH_ID + "-smoke",
    family="vlm",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    modality="vision",
    frontend_seq=16,
    rope_theta=1_000_000.0,
    max_seq_len=512,
)
