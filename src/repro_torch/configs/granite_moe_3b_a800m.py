"""granite-moe-3b-a800m [moe]: 40 experts top-8.

[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]  32L d_model=1536 24H
(GQA kv=8) d_ff=512 (expert width) vocab=49155, MoE 40e top-8.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab=49_155,
    activation="swiglu",
    norm="rmsnorm",
    moe=MoEConfig(n_experts=40, top_k=8, d_ff_expert=512, n_shared_experts=0),
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)

SMOKE = ModelConfig(
    name="granite-moe-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=32,
    vocab=256,
    activation="swiglu",
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=32, n_shared_experts=0),
    dtype="float32",
)
