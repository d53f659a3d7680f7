"""nemotron-4-340b [dense]: GQA, squared-ReLU MLP.  [arXiv:2402.16819; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73728,
    vocab=256_000,
    head_dim=192,
    activation="relu2",
    norm="layernorm",
    rope_theta=10_000.0,
    source="arXiv:2402.16819",
)

SMOKE = ModelConfig(
    name="nemotron-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab=256,
    head_dim=16,
    activation="relu2",
    norm="layernorm",
    dtype="float32",
)
