"""xlstm-125m [ssm]: sLSTM + mLSTM blocks.  [arXiv:2405.04517; unverified]

12L d_model=768 4H vocab=50304, d_ff=0 (mixers carry their own projections).
Every 4th block is sLSTM (xLSTM[m:s] interleave); others mLSTM.
Sub-quadratic: eligible for long_500k (O(1) recurrent state per token).
Uses unrolled layers (12 heterogeneous blocks; compile cost is fine).
"""
from repro_torch.configs.base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50_304,
    norm="layernorm",
    xlstm=XLSTMConfig(slstm_every=4, proj_factor=2.0),
    tie_embeddings=True,
    layer_impl="unroll",
    source="arXiv:2405.04517",
)

SMOKE = ModelConfig(
    name="xlstm-smoke",
    family="ssm",
    n_layers=2,
    d_model=32,
    n_heads=2,
    n_kv_heads=2,
    d_ff=0,
    vocab=256,
    norm="layernorm",
    xlstm=XLSTMConfig(slstm_every=2, proj_factor=2.0),
    tie_embeddings=True,
    layer_impl="unroll",
    dtype="float32",
)
