"""phi3-mini-3.8b [dense]: RoPE SwiGLU GQA.  [arXiv:2404.14219; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32064,
    activation="swiglu",
    norm="rmsnorm",
    rope_theta=10_000.0,
    source="arXiv:2404.14219",
)

SMOKE = ModelConfig(
    name="phi3-mini-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=256,
    activation="swiglu",
    dtype="float32",
)
