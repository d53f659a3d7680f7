"""granite-3-8b [dense]: GQA.  [hf:ibm-granite/granite-3.0-2b-base; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12800,
    vocab=49_155,
    activation="swiglu",
    norm="rmsnorm",
    source="hf:ibm-granite/granite-3.0-2b-base",
)

SMOKE = ModelConfig(
    name="granite-3-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=256,
    activation="swiglu",
    dtype="float32",
)
