"""hymba-1.5b [hybrid]: parallel attention + mamba heads per block.

[arXiv:2411.13676; hf]  32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16.  Sub-quadratic: eligible for long_500k (attention
heads switch to a sliding window in long mode; SSM state is O(1)/token).
Hymba meta-tokens are not modeled (noted in DESIGN.md).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab=32001,
    activation="swiglu",
    norm="rmsnorm",
    hybrid_parallel=True,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    long_window=1024,
    source="arXiv:2411.13676",
)

SMOKE = ModelConfig(
    name="hymba-smoke",
    family="hybrid",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=256,
    activation="swiglu",
    hybrid_parallel=True,
    ssm=SSMConfig(d_state=4, d_conv=4, expand=2),
    long_window=16,
    dtype="float32",
)
