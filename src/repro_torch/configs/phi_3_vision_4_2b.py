"""phi-3-vision-4.2b [vlm]: phi3-mini backbone + CLIP frontend (stub).

[hf:microsoft/Phi-3-vision-128k-instruct; hf]
Backbone only per the brief; the vision frontend is a STUB — input_specs()
provides precomputed patch embeddings (n_img_tokens x d_model).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32064,
    activation="swiglu",
    norm="rmsnorm",
    rope_theta=10_000.0,
    n_img_tokens=576,  # CLIP ViT-L/14-336 -> 24x24 patches
    source="hf:microsoft/Phi-3-vision-128k-instruct",
)

SMOKE = ModelConfig(
    name="phi-3-vision-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=256,
    activation="swiglu",
    norm="rmsnorm",
    n_img_tokens=8,
    dtype="float32",
)
