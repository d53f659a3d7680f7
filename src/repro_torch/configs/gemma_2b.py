"""gemma-2b [dense]: GeGLU, head_dim=256, MQA (kv=1).  [arXiv:2403.08295; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_ff=16384,
    vocab=256_000,
    head_dim=256,
    activation="geglu",
    norm="rmsnorm",
    tie_embeddings=True,
    embed_scale=True,
    source="arXiv:2403.08295",
)

SMOKE = ModelConfig(
    name="gemma-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    d_ff=128,
    vocab=256,
    head_dim=32,
    activation="geglu",
    tie_embeddings=True,
    embed_scale=True,
    dtype="float32",
)
