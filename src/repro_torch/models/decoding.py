"""Prefill / single-token decode with a KV cache, dense family.

Port of the dense path of ``repro.models.decoding``.  Cache layout (layer
major, as in the reference): ``{"k","v": (L,B,M,Hkv,Dh), "pos": (B,)}``.

Unlike the reference, ``decode_step`` writes the new K/V into the cache it is
given, in place, and returns that cache with a new ``pos``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.transformer import (_apply_block, _embed_inputs, check_family,
                                            layer_params)

Params = Dict[str, Any]


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device="cuda") -> Dict[str, torch.Tensor]:
    check_family(cfg)
    dt = L.adtype(cfg)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def prefill(params: Params, cfg: ModelConfig, batch_inputs: Dict[str, torch.Tensor],
            max_len: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Run the full prompt, returning (last-token logits (B,1,V), filled cache)."""
    x, positions, _ = _embed_inputs(params, cfg, batch_inputs)
    b, s, _ = x.shape
    cache = init_cache(cfg, b, max_len, device=x.device)
    m = max_len
    for li in range(cfg.n_layers):
        x, (k, v) = _apply_block(layer_params(params["blocks"], li), x, positions, cfg)
        if s >= m:  # keep the last m positions
            cache["k"][li] = k[:, -m:]
            cache["v"][li] = v[:, -m:]
        else:
            cache["k"][li, :, :s] = k
            cache["v"][li, :, :s] = v
    cache["pos"].fill_(s)
    # the norm is per token, so normalising only the last one is the same
    x = L.apply_norm(params["ln_f"], x[:, -1:], cfg.norm)
    return L.unembed(params["embed"], x, cfg), cache


def _decode_block(p: Params, x: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
                  pos: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """One decoder block for one new token; writes the layer's K/V in place."""
    xn = L.apply_norm(p["ln_attn"], x, cfg.norm)
    attn_out, _ = L.attn_decode(p["attn"], xn, cache_k, cache_v, pos, cfg)
    x = x + attn_out
    xn2 = L.apply_norm(p["ln_mlp"], x, cfg.norm)
    return x + L.apply_mlp(p["mlp"], xn2, cfg.activation)


def decode_step(params: Params, cfg: ModelConfig, cache: Dict[str, torch.Tensor],
                tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token for every sequence.  tokens: (B,1).  Returns (logits (B,1,V),
    cache): the same K/V tensors, written in place, and ``pos + 1``."""
    check_family(cfg)
    pos = cache["pos"]  # (B,) absolute position of the new token
    x = L.embed_tokens(params["embed"], tokens, cfg)
    for li in range(cfg.n_layers):
        x = _decode_block(layer_params(params["blocks"], li), x, cache["k"][li],
                          cache["v"][li], pos, cfg)
    new_cache = dict(cache)
    new_cache["pos"] = pos + 1
    x = L.apply_norm(params["ln_f"], x, cfg.norm)
    return L.unembed(params["embed"], x, cfg), new_cache
