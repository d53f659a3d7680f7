"""whisper-large-v3 [audio]: encoder-decoder, conv frontend STUB.

[arXiv:2212.04356; unverified]  32L (decoder) d_model=1280 20H (kv=20)
d_ff=5120 vocab=51866; 32 encoder layers; input_specs() supplies precomputed
mel-frame embeddings (1500 x d_model) per the brief (frontend is a stub).
rope_theta=0 -> learned absolute position embeddings (whisper style).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="encdec",
    n_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab=51_866,
    activation="gelu",
    norm="layernorm",
    rope_theta=0.0,
    n_enc_layers=32,
    enc_frames=1500,
    source="arXiv:2212.04356",
)

SMOKE = ModelConfig(
    name="whisper-smoke",
    family="encdec",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=256,
    activation="gelu",
    norm="layernorm",
    rope_theta=0.0,
    n_enc_layers=2,
    enc_frames=16,
    dtype="float32",
)
