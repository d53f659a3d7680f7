"""moonshot-v1-16b-a3b [moe]: kimi/moonlight, 64 experts top-6.

[hf:moonshotai/Moonlight-16B-A3B; hf]  48L d_model=2048 16H (GQA kv=16)
d_ff=1408 (expert width) vocab=163840, MoE 64e top-6 + 2 shared experts.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=163_840,
    activation="swiglu",
    norm="rmsnorm",
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408, n_shared_experts=2),
    source="hf:moonshotai/Moonlight-16B-A3B",
)

SMOKE = ModelConfig(
    name="moonshot-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=32,
    vocab=256,
    activation="swiglu",
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=32, n_shared_experts=1),
    dtype="float32",
)
