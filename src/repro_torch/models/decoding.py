"""Prefill / single-token decode with KV + recurrent-state caches, for every
family of the reference.

Port of ``repro.models.decoding``.  Cache layouts (layer major, as in the
reference):
  dense, vlm, moe : {"k","v": (L,B,M,Hkv,Dh), "pos": (B,)}
  hybrid          : + {"conv": (L,B,k-1,di) activation dtype, "ssm": (L,B,di,n) f32}
  encdec          : + {"cross_k","cross_v": (L,B,F,Hkv,Dh)}, the encoder output's
                    K/V for each decoder layer, fixed after prefill
  ssm (xlstm)     : {"blocks": [per-layer state dicts, batch-first], "pos": (B,)}

The vlm prompt is its stub image rows and then its tokens, so ``pos`` after
prefill counts both.  encdec's ``decode_step`` adds no decoder position
embedding: the reference's does not either (decoding.py:207 there; only its
prefill adds ``dec_pos``), so a decoded token carries no position signal, and
the port computes what the reference computes.

``window > 0`` is the reference's sliding-window mode: a circular KV buffer
of M = min(window, max_len) slots.  A prefill of s >= M tokens keeps the
last M keys in slots 0..M-1, every prefill attends through the window on the
plain path (no K1, as in the reference), and ``decode_step`` writes at slot
``pos % M`` and attends min(pos + 1, M) slots (through K2 on ``"pallas"``).
After a prefill with s > M and s % M != 0 the first step thus overwrites the
key of position s - M + s % M, not the oldest one (s - M): the reference
does the same (ROADMAP.md, R2), and the port computes what it computes.  The
encdec and ssm families ignore ``window``, as in the reference.

Unlike the reference, ``decode_step`` writes the new K/V and recurrent states
into the cache it is given, in place, and returns that cache with a new
``pos`` (xlstm returns new state dicts).

On a mesh (DTensor params and inputs, ``steps.py``; every family)
``prefill``'s cache is born a DTensor with the placements of
``sharding.cache_pspecs``, and every write keeps them: a layer's K/V, its
recurrent state and encdec's cross K/V are re-placed to the cache's layout
before they are copied in, and ``decode_step`` writes each rank's own
shard (``layers.attn_decode``).  The xlstm states a step returns are
re-placed to their ``cache_pspecs`` placements (``_placed_states``).  The
production mesh and the dry-run on a mesh wait for ROADMAP.md Queue 1
item 5a-iv.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch import sharding as SH
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM
from repro_torch.models import xlstm as XL
from repro_torch.models.transformer import (_apply_block, _embed_inputs, _ffn, _run_xlstm,
                                            check_family, encoder_output, layer_params,
                                            mix, xlstm_layer_kinds)

Params = Dict[str, Any]

def init_cache(cfg: ModelConfig, batch: int, max_len: int, window: int = 0,
               device="cuda", mesh=None) -> Dict[str, Any]:
    """An empty cache of ``batch`` rows; its K/V hold M = min(window,
    max_len) slots when ``window`` > 0, else ``max_len``.  With a ``mesh``
    (a ``DeviceMesh``) every leaf is a DTensor of zeros placed by
    ``sharding.cache_pspecs``, each rank allocating its shard alone."""
    if cfg.family == "ssm":  # on a mesh the states are born placed, not all zeros
        blocks = [XL.init_mlstm_state(cfg, batch, device=device, mesh=mesh) if kind == "mlstm"
                  else XL.init_slstm_state(cfg, batch, device=device, mesh=mesh)
                  for kind in xlstm_layer_kinds(cfg)]
        return {"blocks": blocks, "pos": _xlstm_pos(batch, 0, blocks[0]["m"])}
    if mesh is not None:
        spec = cache_specs(cfg, batch, max_len, window)
        return SH.tree_map(lambda t, p: SH.filled(t.shape, 0, t.dtype, device, mesh,
                                                  SH.placements(p, mesh)),
                           spec, SH.cache_pspecs(cfg, spec, mesh))
    check_family(cfg)
    dt = L.adtype(cfg)
    m = min(window, max_len) if window else max_len
    shape = (cfg.n_layers, batch, m, cfg.n_kv_heads, cfg.resolved_head_dim)
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


def cache_specs(cfg: ModelConfig, batch: int, max_len: int, window: int = 0) -> Dict[str, Any]:
    """``init_cache`` as ``meta`` tensors: the cache's shapes and dtypes,
    nothing allocated (the reference's ``jax.eval_shape`` of it)."""
    return init_cache(cfg, batch, max_len, window, device="meta")


def prefill(params: Params, cfg: ModelConfig, batch_inputs: Dict[str, torch.Tensor],
            max_len: int, window: int = 0) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run the full prompt, returning (last-token logits (B,1,V), filled cache).
    ``batch_inputs`` holds ``tokens`` and the stub frontend's ``img_embeds``
    (vlm) or ``enc_frames`` (encdec, whose encoder runs first).  ``window``:
    see the module docstring."""
    if cfg.family == "ssm":
        return _prefill_xlstm(params, cfg, batch_inputs)
    if cfg.family == "encdec":
        window = 0
    enc = encoder_output(params, cfg, batch_inputs)
    x, positions, _ = _embed_inputs(params, cfg, batch_inputs)
    b, s, _ = x.shape
    if cfg.family == "encdec" and s > max_len:  # the reference does not truncate this prompt
        raise ValueError(f"encdec prompt of {s} tokens is longer than max_len={max_len}")
    mesh = x.device_mesh if isinstance(x, DTensor) else None
    cache = init_cache(cfg, b, max_len, window, device=x.device, mesh=mesh)
    m = cache["k"].shape[2]
    for li in range(cfg.n_layers):
        x, (k, v), state, _ = _apply_block(layer_params(params["blocks"], li), x, positions,
                                           cfg, enc, window=window)
        for key, t in state.items():  # conv and ssm (hybrid), cross_k and cross_v (encdec)
            _store(cache[key][li], t)
        if s >= m:  # keep the last m positions
            _store(cache["k"][li], k[:, -m:])
            _store(cache["v"][li], v[:, -m:])
        elif mesh is not None:  # the whole layer, its empty slots zero: the
            # slots of an M-sharded cache are not a view of a slice
            empty = SH.zeros_beside(k, (b, m - s) + tuple(k.shape[2:]), 1)
            _store(cache["k"][li], torch.cat([k, empty], dim=1))
            _store(cache["v"][li], torch.cat([v, empty], dim=1))
        else:
            cache["k"][li, :, :s] = k
            cache["v"][li, :, :s] = v
    cache["pos"].fill_(s)
    # the norm is per token, so normalising only the last one is the same
    x = L.apply_norm(params["ln_f"], x[:, -1:], cfg.norm)
    return L.unembed(params["embed"], x, cfg), cache


def _store(dst: torch.Tensor, src: torch.Tensor) -> None:
    """Copy ``src`` into the cache view ``dst`` in place; on a mesh ``src`` is
    first re-placed to ``dst``'s placements, so each rank writes its shard."""
    if isinstance(dst, DTensor):
        src = SH.relayout(src, dst.placements)
    dst.copy_(src)


def _xlstm_pos(b: int, s: int, like: torch.Tensor) -> torch.Tensor:
    return SH.replicate_like(torch.full((b,), s, dtype=torch.int32, device=like.device), like)


def _placed_states(cfg: ModelConfig, states: list, pos: torch.Tensor) -> Dict[str, Any]:
    """The xlstm cache; on a mesh each state leaf re-placed to its
    ``cache_pspecs`` placements (a step's ops leave them where DTensor's
    rules put them)."""
    cache = {"blocks": states, "pos": pos}
    if not isinstance(pos, DTensor):
        return cache
    mesh = pos.device_mesh
    return SH.tree_map(lambda t, p: SH.relayout(t, SH.placements(p, mesh)),
                       cache, SH.cache_pspecs(cfg, cache, mesh))


def _prefill_xlstm(params: Params, cfg: ModelConfig, batch_inputs: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    x = L.embed_tokens(params["embed"], batch_inputs["tokens"], cfg)
    b, s, _ = x.shape
    x, states = _run_xlstm(params, x, cfg)
    x = L.apply_norm(params["ln_f"], x[:, -1:], cfg.norm)
    return L.unembed(params["embed"], x, cfg), _placed_states(cfg, states, _xlstm_pos(b, s, x))


def _decode_block(p: Params, x: torch.Tensor, layer: Dict[str, torch.Tensor],
                  pos: torch.Tensor, cfg: ModelConfig, write_pos: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decoder block for one new token.  ``layer`` is the layer's slice
    of the cache; its K/V are written in place (the same new row on every
    call) at slot ``write_pos`` (default ``pos``), its recurrent state and
    cross K/V are only read.  Returns (x, new recurrent state), the state
    empty but for hybrid.  The moe block routes
    the B tokens as B groups of one (no drops); its aux is discarded."""
    xn = L.apply_norm(p["ln_attn"], x, cfg.norm)
    attn_out, _ = L.attn_decode(p["attn"], xn, layer["k"], layer["v"], pos, cfg,
                                write_pos=write_pos)
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


def decode_step(params: Params, cfg: ModelConfig, cache: Dict[str, Any],
                tokens: torch.Tensor, window: int = 0) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One token for every sequence.  tokens: (B,1).  Returns (logits (B,1,V),
    cache): the same K/V (and conv/ssm) tensors, written in place (at slot
    ``pos % M`` when ``window`` > 0), the cross K/V unchanged, and
    ``pos + 1``.  No position embedding is added (see the module
    docstring)."""
    check_family(cfg)
    if cfg.family == "ssm":
        return _decode_xlstm(params, cfg, cache, tokens)
    pos = cache["pos"]  # (B,) absolute position of the new token
    write_pos = pos % cache["k"].shape[2] if window else pos
    x = L.embed_tokens(params["embed"], tokens, cfg)
    for li in range(cfg.n_layers):
        layer = {key: t[li] for key, t in cache.items() if key != "pos"}
        x, state = _decode_block(layer_params(params["blocks"], li), x, layer, pos, cfg,
                                 write_pos)
        for key, t in state.items():
            _store(cache[key][li], t)
    new_cache = dict(cache)
    new_cache["pos"] = pos + 1
    x = L.apply_norm(params["ln_f"], x, cfg.norm)
    return L.unembed(params["embed"], x, cfg), new_cache


def _decode_xlstm(params: Params, cfg: ModelConfig, cache: Dict[str, Any],
                  tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, Any]]:
    x = L.embed_tokens(params["embed"], tokens, cfg)
    states = []
    for kind, p, st in zip(xlstm_layer_kinds(cfg), params["blocks"], cache["blocks"]):
        if kind == "mlstm":
            out, st = XL.mlstm_decode(p, x, st, cfg)
            x = x + out
        else:
            x, st = XL.slstm_decode(p, x, st, cfg)
        states.append(st)
    x = L.apply_norm(params["ln_f"], x, cfg.norm)
    return L.unembed(params["embed"], x, cfg), _placed_states(cfg, states, cache["pos"] + 1)
