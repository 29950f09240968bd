"""whisper-tiny — encoder-decoder audio model (conv frontend stubbed).

4L d_model=384 6H d_ff=1536 vocab=51865; the encoder takes 1500 frame
embeddings (the mel and conv frontend is a stub), the decoder is causal
with cross-attention.  [arXiv:2212.04356]
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "whisper-tiny"

FULL = ModelConfig(
    name=ARCH_ID,
    family="audio",
    num_layers=4,  # decoder layers
    num_encoder_layers=4,
    is_encoder_decoder=True,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51_865,
    modality="audio",
    frontend_seq=1500,  # 30 s of audio: 1500 frames after the conv stub
    activation="gelu",
    rope_theta=0.0,  # sinusoidal (encoder) and learned (decoder) positions
    max_seq_len=32_768,
)

SMOKE = ModelConfig(
    name=ARCH_ID + "-smoke",
    family="audio",
    num_layers=2,
    num_encoder_layers=2,
    is_encoder_decoder=True,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    d_ff=256,
    vocab_size=512,
    modality="audio",
    frontend_seq=64,
    activation="gelu",
    rope_theta=0.0,
    max_seq_len=512,
)
