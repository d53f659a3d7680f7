"""Core layers of the dense decoder: norms, RoPE, GQA attention (prefill and
decode), MLPs, embedding.

Port of the dense subset of ``repro.models.layers``, with the same
convention: ``<layer>_defs(cfg)`` returns a dict of ParamDef and
``<layer>(params, x, ...)`` applies it.  Softmax and norms run in f32 and
cast back to the activation dtype, as in the reference.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models.params import ParamDef

Params = Dict[str, torch.Tensor]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def adtype(cfg) -> torch.dtype:
    """The activation/param dtype named by ``cfg.dtype``."""
    return _DTYPES[cfg.dtype]


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def norm_defs(cfg) -> Params:
    d = cfg.d_model
    out = {"scale": ParamDef((d,), ("embed",), init="ones", dtype=torch.float32)}
    if cfg.norm == "layernorm":
        out["bias"] = ParamDef((d,), ("embed",), init="zeros", dtype=torch.float32)
    return out


def apply_norm(p: Params, x: torch.Tensor, kind: str) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        var = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + 1e-6) * p["scale"]
    elif kind == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + 1e-5) * p["scale"] + p["bias"]
    else:
        raise ValueError(kind)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (llama-style half-rotation)
# ---------------------------------------------------------------------------


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int."""
    if theta <= 0:
        return x
    half = x.shape[-1] // 2
    ar = torch.arange(0, half, dtype=torch.float32, device=x.device)
    freqs = torch.exp(-math.log(theta) * ar / half)
    ang = positions.float()[..., None] * freqs  # (B,S,half), f32 from int positions
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA / MQA), causal prefill + decode over a cache
# ---------------------------------------------------------------------------


def attention_defs(cfg) -> Params:
    d, h = cfg.d_model, cfg.resolved_head_dim
    dt = adtype(cfg)
    return {
        "wq": ParamDef((d, cfg.n_heads, h), ("embed", "heads", "head_dim"), dtype=dt),
        "wk": ParamDef((d, cfg.n_kv_heads, h), ("embed", "kv_heads", "head_dim"), dtype=dt),
        "wv": ParamDef((d, cfg.n_kv_heads, h), ("embed", "kv_heads", "head_dim"), dtype=dt),
        "wo": ParamDef((cfg.n_heads, h, d), ("heads", "head_dim", "embed"), dtype=dt),
    }


def _gqa_scores(q: torch.Tensor, k: torch.Tensor, n_rep: int, hd: int) -> torch.Tensor:
    """q: (B,Sq,Hq,D), k: (B,Sk,Hkv,D) -> f32 scores / sqrt(D), (B,Hkv,G,Sq,Sk)."""
    b, sq, hq, d = q.shape
    qg = q.reshape(b, sq, k.shape[2], n_rep, d)
    # the product is in the activation dtype, then scaled in f32, as in JAX
    return torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float() / math.sqrt(hd)


def _gqa_out(w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """w: (B,Hkv,G,Sq,Sk), v: (B,Sk,Hkv,D) -> (B,Sq,Hq,D)."""
    b, hkv, g, sq, sk = w.shape
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v)
    return out.reshape(b, sq, hkv * g, out.shape[-1])


def _masked_softmax(scores: torch.Tensor, mask: torch.Tensor, dtype) -> torch.Tensor:
    # -1e30 (not -inf) masking, f32 softmax, then cast to the activation
    # dtype BEFORE the product with V (layers.py:106-108 of the reference)
    scores = torch.where(mask, scores.float(), torch.full((), -1e30, device=scores.device))
    return torch.softmax(scores, dim=-1).to(dtype)


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bsd,dhk->bshk", x, w)


def attn_forward(p: Params, x: torch.Tensor, positions: torch.Tensor, cfg
                 ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Causal self-attention for prefill.  Returns (out, (k, v)) for the cache."""
    hd = cfg.resolved_head_dim
    n_rep = cfg.n_heads // cfg.n_kv_heads
    q = apply_rope(_project(x, p["wq"]), positions, cfg.rope_theta)
    k = apply_rope(_project(x, p["wk"]), positions, cfg.rope_theta)
    v = _project(x, p["wv"])
    impl = cfg.attention_impl
    if impl == "pallas":
        # K1: the CUDA flash-attention kernel for CUDA tensors, its plain
        # version for CPU tensors
        out = kops.flash_attention(q, k, v)
    elif impl == "xla":
        scores = _gqa_scores(q, k, n_rep, hd)
        sq, sk = scores.shape[-2], scores.shape[-1]
        iq = torch.arange(sq, device=x.device)[:, None]
        ik = torch.arange(sk, device=x.device)[None, :]
        out = _gqa_out(_masked_softmax(scores, ik <= iq, x.dtype), v)
    else:
        raise NotImplementedError(f"attention_impl={impl!r} is not ported; "
                                  "the port has 'xla' and 'pallas'")
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), (k, v)


def attn_decode(p: Params, x: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
                pos: torch.Tensor, cfg) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Single-token decode.  x: (B,1,d); cache_{k,v}: (B,M,Hkv,D), UPDATED IN
    PLACE and returned.

    ``pos`` (B,) is the absolute position of the new token: it drives RoPE,
    the slot written and the valid-length mask.  A position >= M writes
    nothing, as the reference's one-hot blend does."""
    hd = cfg.resolved_head_dim
    n_rep = cfg.n_heads // cfg.n_kv_heads
    b, m = x.shape[0], cache_k.shape[1]
    q = apply_rope(_project(x, p["wq"]), pos[:, None], cfg.rope_theta)
    k_new = apply_rope(_project(x, p["wk"]), pos[:, None], cfg.rope_theta)
    v_new = _project(x, p["wv"])
    # The reference writes with a one-hot blend over all M slots; here the
    # one slot is written in place.  Out-of-range rows rewrite their old
    # value (no host sync to find them).
    rows = torch.arange(b, device=x.device)
    in_range = (pos < m)[:, None, None]
    slot = pos.clamp(max=m - 1).long()
    cache_k[rows, slot] = torch.where(in_range, k_new[:, 0], cache_k[rows, slot])
    cache_v[rows, slot] = torch.where(in_range, v_new[:, 0], cache_v[rows, slot])
    valid = torch.clamp(pos + 1, max=m).to(torch.int32)
    impl = cfg.attention_impl
    if impl == "pallas":
        # K2: the CUDA flash-decode kernel (plain version on the CPU)
        out = kops.decode_attention(q, cache_k, cache_v, valid)
    elif impl == "xla":
        scores = _gqa_scores(q, cache_k, n_rep, hd)  # (B,Hkv,G,1,M)
        mask = torch.arange(m, device=x.device)[None, :] < valid[:, None]  # (B,M)
        w = _masked_softmax(scores, mask[:, None, None, None, :], x.dtype)
        out = _gqa_out(w, cache_v)
    else:
        raise NotImplementedError(f"attention_impl={impl!r} is not ported; "
                                  "the port has 'xla' and 'pallas'")
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), (cache_k, cache_v)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def mlp_defs(cfg) -> Params:
    d, dff = cfg.d_model, cfg.d_ff
    dt = adtype(cfg)
    if cfg.activation in ("swiglu", "geglu"):
        return {
            "w1": ParamDef((d, dff), ("embed", "mlp"), dtype=dt),
            "w3": ParamDef((d, dff), ("embed", "mlp"), dtype=dt),
            "w2": ParamDef((dff, d), ("mlp", "embed"), dtype=dt),
        }
    return {
        "w1": ParamDef((d, dff), ("embed", "mlp"), dtype=dt),
        "w2": ParamDef((dff, d), ("mlp", "embed"), dtype=dt),
    }


def apply_mlp(p: Params, x: torch.Tensor, activation: str) -> torch.Tensor:
    h = x @ p["w1"]
    # jax.nn.gelu defaults to the tanh approximation
    if activation == "swiglu":
        h = F.silu(h) * (x @ p["w3"])
    elif activation == "geglu":
        h = F.gelu(h, approximate="tanh") * (x @ p["w3"])
    elif activation == "relu2":
        h = torch.square(F.relu(h))
    elif activation == "gelu":
        h = F.gelu(h, approximate="tanh")
    else:
        raise ValueError(activation)
    return h @ p["w2"]


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embed_defs(cfg) -> Params:
    dt = adtype(cfg)
    out = {
        "embedding": ParamDef(
            (cfg.vocab, cfg.d_model), ("vocab", "embed"), init="embed", scale=1.0, dtype=dt
        )
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = ParamDef((cfg.d_model, cfg.vocab), ("embed", "vocab"), dtype=dt)
    return out


def embed_tokens(p: Params, tokens: torch.Tensor, cfg) -> torch.Tensor:
    x = p["embedding"][tokens]  # gather
    if cfg.embed_scale:
        # sqrt(d_model) is cast to the activation dtype BEFORE the multiply
        # (in bf16, sqrt(2048) becomes 45.25)
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype, device=x.device)
    return x


def unembed(p: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x, p["embedding"])
    return torch.einsum("bsd,dv->bsv", x, p["lm_head"])
