"""Prefill / single-token decode with KV + recurrent-state caches, dense,
vlm, hybrid, moe and encdec families.

Port of ``repro.models.decoding`` but its xlstm path.  Cache layouts (layer
major, as in the reference):
  dense, vlm, moe : {"k","v": (L,B,M,Hkv,Dh), "pos": (B,)}
  hybrid          : + {"conv": (L,B,k-1,di) activation dtype, "ssm": (L,B,di,n) f32}
  encdec          : + {"cross_k","cross_v": (L,B,F,Hkv,Dh)}, the encoder output's
                    K/V for each decoder layer, fixed after prefill

The vlm prompt is its stub image rows and then its tokens, so ``pos`` after
prefill counts both.  encdec's ``decode_step`` adds no decoder position
embedding: the reference's does not either (decoding.py:207 there; only its
prefill adds ``dec_pos``), so a decoded token carries no position signal, and
the port computes what the reference computes.

Unlike the reference, ``decode_step`` writes the new K/V and recurrent states
into the cache it is given, in place, and returns that cache with a new
``pos``.  The reference's sliding-window mode (``window > 0``, a circular KV
buffer) is not ported.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM
from repro_torch.models.transformer import (_apply_block, _embed_inputs, _ffn, check_family,
                                            encoder_output, layer_params, mix)

Params = Dict[str, Any]


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device="cuda") -> Dict[str, torch.Tensor]:
    check_family(cfg)
    dt = L.adtype(cfg)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    cache = {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }
    if cfg.family == "hybrid":
        state = SSM.init_ssm_state(cfg, batch, device=device)
        for key, t in state.items():  # one per layer
            cache[key] = t.expand(cfg.n_layers, *t.shape).contiguous()
    if cfg.family == "encdec":
        cross = shape[:2] + (cfg.enc_frames,) + shape[3:]
        cache["cross_k"] = torch.zeros(cross, dtype=dt, device=device)
        cache["cross_v"] = torch.zeros(cross, dtype=dt, device=device)
    return cache


def prefill(params: Params, cfg: ModelConfig, batch_inputs: Dict[str, torch.Tensor],
            max_len: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Run the full prompt, returning (last-token logits (B,1,V), filled cache).
    ``batch_inputs`` holds ``tokens`` and the stub frontend's ``img_embeds``
    (vlm) or ``enc_frames`` (encdec, whose encoder runs first)."""
    enc = encoder_output(params, cfg, batch_inputs)
    x, positions, _ = _embed_inputs(params, cfg, batch_inputs)
    b, s, _ = x.shape
    m = max_len
    if cfg.family == "encdec" and s > m:  # the reference does not truncate this prompt
        raise ValueError(f"encdec prompt of {s} tokens is longer than max_len={m}")
    cache = init_cache(cfg, b, m, device=x.device)
    for li in range(cfg.n_layers):
        x, (k, v), state, _ = _apply_block(layer_params(params["blocks"], li), x, positions,
                                           cfg, enc)
        for key, t in state.items():  # conv and ssm (hybrid), cross_k and cross_v (encdec)
            cache[key][li] = t
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


def _decode_block(p: Params, x: torch.Tensor, layer: Dict[str, torch.Tensor],
                  pos: torch.Tensor, cfg: ModelConfig
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decoder block for one new token.  ``layer`` is the layer's slice
    of the cache; its K/V are written in place (the same new row on every
    call), its recurrent state and cross K/V are only read.  Returns (x, new
    recurrent state), the state empty but for hybrid.  The moe block routes
    the B tokens as B groups of one (no drops); its aux is discarded."""
    xn = L.apply_norm(p["ln_attn"], x, cfg.norm)
    attn_out, _ = L.attn_decode(p["attn"], xn, layer["k"], layer["v"], pos, cfg)
    state: Dict[str, torch.Tensor] = {}
    if cfg.family == "hybrid":
        ssm_out, state = SSM.ssm_decode(p["ssm"], xn, layer, cfg)
        x = mix(p, x, attn_out, ssm_out)
    else:
        x = x + attn_out
    if cfg.family == "encdec":
        xn = L.apply_norm(p["ln_cross"], x, cfg.norm)
        x = x + L.attn_decode(p["cross"], xn, layer["cross_k"], layer["cross_v"], pos, cfg,
                              cross=True)[0]
    ffn_out, _ = _ffn(p, L.apply_norm(p["ln_mlp"], x, cfg.norm), cfg)
    return x + ffn_out, state


def decode_step(params: Params, cfg: ModelConfig, cache: Dict[str, torch.Tensor],
                tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token for every sequence.  tokens: (B,1).  Returns (logits (B,1,V),
    cache): the same K/V (and conv/ssm) tensors, written in place, the
    cross K/V unchanged, and ``pos + 1``.  No position embedding is added
    (see the module docstring)."""
    check_family(cfg)
    pos = cache["pos"]  # (B,) absolute position of the new token
    x = L.embed_tokens(params["embed"], tokens, cfg)
    for li in range(cfg.n_layers):
        layer = {key: t[li] for key, t in cache.items() if key != "pos"}
        x, state = _decode_block(layer_params(params["blocks"], li), x, layer, pos, cfg)
        for key, t in state.items():
            cache[key][li] = t
    new_cache = dict(cache)
    new_cache["pos"] = pos + 1
    x = L.apply_norm(params["ln_f"], x, cfg.norm)
    return L.unembed(params["embed"], x, cfg), new_cache
