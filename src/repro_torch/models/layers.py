"""Core layers: norms, RoPE, GQA attention (causal, bidirectional and
cross, for prefill and decode), MLPs, embedding, learned position tables.

Port of ``repro.models.layers``, with the same convention:
``<layer>_defs(cfg)`` returns a dict of ParamDef and ``<layer>(params, x,
...)`` applies it.  Softmax and norms run in f32 and cast back to the
activation dtype, as in the reference.

On a mesh (the sharded step bundles, ``steps.py``) the activations, params
and cache are DTensors, and DTensor propagates their placements through
every op here.  Two things it cannot do are done by hand.  Constants made
from the device (``arange`` masks and frequencies) are wrapped as
replicated DTensors (``sharding.replicate_like``): DTensor refuses to mix
plain tensors in.  And a kernel wrapper only ever sees plain tensors: K1,
K2 and the cache write around K2 run on each rank's local tensors in
``local_map`` islands (``sharding.local_call``), after the operands are
re-placed to a layout in which the local call is exact
(``_attention_layouts``).  A cache stored sharded on head_dim (an MQA
cache) or on M (``decode_seq_shard``) is gathered for K2 so; the bytes are
counted in ``sharding.relayout.gathered_bytes``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch import sharding as SH
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
    ar = SH.replicate_like(torch.arange(0, half, dtype=torch.float32, device=x.device), x)
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


def _whole_groups(q: torch.Tensor, hkv: int) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """(q, the mesh dims re-placed) with q (B,Sq,Hq,D), a DTensor, re-placed
    with its heads unsharded on every mesh dim whose size does not divide
    Hkv: splitting Hq into (Hkv, G) keeps a shard only of whole kv heads (or
    of the G heads of MQA's one).  The attention's output is sharded back on
    those dims (``_regroup``), so that its grad reaches the split's backward
    in the layout the forward had.  (q, ()) for a plain q."""
    if not isinstance(q, DTensor) or hkv == 1:
        return q, ()
    mesh = q.device_mesh
    dims = tuple(i for i, p in enumerate(q.placements) if p == Shard(2) and hkv % mesh.size(i))
    return SH.relayout(q, [Replicate() if i in dims else p
                           for i, p in enumerate(q.placements)]), dims


def _regroup(out: torch.Tensor, dims: Tuple[int, ...]) -> torch.Tensor:
    if not dims:
        return out
    return SH.relayout(out, [Shard(2) if i in dims else p for i, p in enumerate(out.placements)])


def _gqa_scores(q: torch.Tensor, k: torch.Tensor, n_rep: int, hd: int) -> torch.Tensor:
    """q: (B,Sq,Hq,D), k: (B,Sk,Hkv,D) -> f32 scores / sqrt(D), (B,Hkv,G,Sq,Sk)."""
    b, sq, hq, d = q.shape
    qg = q.reshape(b, sq, k.shape[2], n_rep, d)
    # the product is in the activation dtype, then scaled in f32, as in JAX
    return SH.batch_einsum("bqhgd,bkhd->bhgqk", qg, k).float() / math.sqrt(hd)


def _gqa_out(w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """w: (B,Hkv,G,Sq,Sk), v: (B,Sk,Hkv,D) -> (B,Sq,Hq,D)."""
    b, hkv, g, sq, sk = w.shape
    out = SH.batch_einsum("bhgqk,bkhd->bqhgd", w, v)
    return SH.pin_grad(out.reshape(b, sq, hkv * g, out.shape[-1]), 2, hkv)


def _masked_softmax(scores: torch.Tensor, mask: Optional[torch.Tensor], dtype) -> torch.Tensor:
    # -1e30 (not -inf) masking, f32 softmax, then cast to the activation
    # dtype BEFORE the product with V (layers.py:106-108 of the reference).
    # No mask: every key is attended (the reference's all-true mask)
    scores = scores.float()
    if mask is not None:
        scores = torch.where(mask, scores, torch.full((), -1e30, device=scores.device))
    return torch.softmax(scores, dim=-1).to(dtype)


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bsd,dhk->bshk", x, w)


def _out_project(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """The output projection of the attention's (B,S,H,D) ``out``.  On a
    mesh, an ``out`` sharded on head_dim (V stored so) or on heads that do
    not divide their mesh dim is first gathered there: the einsum merges (H,
    D), and DTensor has no placement for such a merge (torch 2.11 refuses
    the first on a 16 x 16 mesh, 2.13 the second)."""
    if isinstance(out, DTensor):
        mesh = out.device_mesh
        out = SH.relayout(out, [
            Replicate() if p == Shard(3) or (p == Shard(2) and out.shape[2] % mesh.size(i))
            else p for i, p in enumerate(out.placements)])
    return torch.einsum("bshk,hkd->bsd", out, wo)


def cross_attention_defs(cfg) -> Params:
    return attention_defs(cfg)


def _plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: Optional[torch.Tensor], cfg) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v in plain PyTorch; q (B,Sq,Hq,D), k/v
    (B,Sk,Hkv,D); ``mask`` broadcasts to (B,Hkv,G,Sq,Sk), None for all keys."""
    hd = cfg.resolved_head_dim
    q, dims = _whole_groups(q, k.shape[2])
    scores = _gqa_scores(q, k, cfg.n_heads // cfg.n_kv_heads, hd)
    if isinstance(scores, DTensor) and any(p.is_partial() for p in scores.placements):
        # K sharded on head_dim (a cache stored so: MQA's, or encdec's cross
        # K/V when the heads do not divide "model") leaves the scores a
        # partial sum: reduced here, its bytes counted
        scores = SH.relayout(scores, [Replicate() if p.is_partial() else p
                                      for p in scores.placements])
    return _regroup(_gqa_out(_masked_softmax(scores, mask, q.dtype), v), dims)


ATTENTION_IMPLS = ("xla", "pallas", "blockwise", "blockwise_u")


def _check_impl(impl: str) -> None:
    if impl not in ATTENTION_IMPLS:
        raise NotImplementedError(f"attention_impl={impl!r} is not ported; "
                                  f"the port has {ATTENTION_IMPLS}")


def _blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg,
                         window: int) -> torch.Tensor:
    """Causal self-attention in chunks of ``cfg.attention_block_q`` queries
    (reference layers.py:111): each chunk's (B,Hkv,G,bq,S) f32 scores, the
    causal mask (and the ``window``), the f32 softmax and the product with
    V, so the (S,S) scores never exist at once.  S is padded with zero
    queries to a multiple of the chunk; their rows are cut.  The masks are
    built on the device from ``arange``s.  q: (B,S,Hq,D), k/v: (B,S,Hkv,D).

    The reference's ``blockwise`` runs the chunks in a ``lax.scan`` and
    ``blockwise_u`` unrolls them in Python, with the same numbers.  In eager
    PyTorch both are this one Python loop, which autograd differentiates
    for training; no kernel is involved."""
    b, s, hq, d = q.shape
    bq = min(cfg.attention_block_q, s)
    pad = (-s) % bq
    if pad:  # zero queries (F.pad has no sound DTensor rule in every torch)
        q = torch.cat([q, SH.zeros_beside(q, (b, pad) + tuple(q.shape[2:]), 1)], dim=1)
    n_rep = cfg.n_heads // cfg.n_kv_heads
    q, dims = _whole_groups(q, k.shape[2])
    kt = SH.replicate_like(torch.arange(s, device=q.device)[None, :], q)
    rows = SH.replicate_like(torch.arange(bq, device=q.device)[:, None], q)
    outs = []
    for lo in range(0, s + pad, bq):
        scores = _gqa_scores(q[:, lo:lo + bq], k, n_rep, cfg.resolved_head_dim)
        mask = kt <= rows + lo
        if window > 0:
            mask = mask & (kt > rows + lo - window)
        outs.append(_gqa_out(_masked_softmax(scores, mask, q.dtype), v))
    return _regroup(torch.cat(outs, dim=1)[:, :s], dims)


def _maybe_seq_shard(x: torch.Tensor, cfg) -> torch.Tensor:
    """attention_partitioning="seq": re-place x (a DTensor) with its seq dim
    over "model" and its batch over the dp axes where that divides
    (reference layers.py:150).  The identity without an installed mesh
    (``parallel.ep.current_mesh``), for a plain tensor, or when the seq dim
    does not divide."""
    if getattr(cfg, "attention_partitioning", "auto") != "seq":
        return x
    from repro_torch.parallel.ep import current_mesh

    mesh = current_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    shape = SH.mesh_shape(mesh)
    if "model" not in shape or x.shape[1] % shape["model"] != 0:
        return x
    dpsz = SH.dp_size(mesh)
    bt = "dp" if x.shape[0] % dpsz == 0 and dpsz > 1 else None
    return SH.relayout(x, SH.kernel_layout(mesh, (bt, "model") + (None,) * (x.dim() - 2)))


def _attention_layouts(mesh, b: int, hq: int, hkv: int) -> Tuple[tuple, tuple, tuple]:
    """(q and out, k and v, lengths) placements under which K1 and K2 on each
    rank's local tensors compute exactly that rank's slice of the result:
    the batch over the dp axes where it divides; the heads over "model" when
    Hq and Hkv both divide (each rank keeps whole GQA groups), q's alone
    when Hkv is 1 (MQA: every rank needs the one kv head), else no head
    split (every rank computes every head)."""
    shape = SH.mesh_shape(mesh)
    msz = shape.get("model", 1)
    bt = "dp" if b % SH.dp_size(mesh) == 0 else None
    qh = "model" if hq % msz == 0 and (hkv % msz == 0 or hkv == 1) else None
    kvh = "model" if qh and hkv % msz == 0 else None
    return (SH.kernel_layout(mesh, (bt, None, qh, None)),
            SH.kernel_layout(mesh, (bt, None, kvh, None)), SH.kernel_layout(mesh, (bt,)))


def _flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """K1, on a mesh in a ``local_map`` island."""
    if not isinstance(q, DTensor):
        return kops.flash_attention(q, k, v)
    qp, kvp, _ = _attention_layouts(q.device_mesh, q.shape[0], q.shape[2], k.shape[2])
    return SH.local_call(kops.flash_attention, (qp, kvp, kvp), qp, q, k, v)


def _flash_decode(q: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """K2, on a mesh in a ``local_map`` island, the cache first gathered to
    the kernel's layout where it is stored otherwise."""
    if not isinstance(q, DTensor):
        return kops.decode_attention(q, cache_k, cache_v, valid)
    qp, kvp, lp = _attention_layouts(q.device_mesh, q.shape[0], q.shape[2], cache_k.shape[2])
    return SH.local_call(kops.decode_attention, (qp, kvp, kvp, lp), qp,
                         q, cache_k, cache_v, valid)


def _write_slot(cache_k: torch.Tensor, cache_v: torch.Tensor, k_new: torch.Tensor,
                v_new: torch.Tensor, write_pos: torch.Tensor, lo: int = 0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write row b's new K/V (B,1,Hkv,D) in place at slot write_pos[b] - lo
    of the caches (B,M,Hkv,D), whose slots hold positions lo..lo+M-1.  The
    reference writes with a one-hot blend over all M slots; here the one
    slot is written.  A row whose slot lies outside rewrites its old value
    (no host sync to find those rows)."""
    b, m = cache_k.shape[:2]
    rows = torch.arange(b, device=cache_k.device)
    local = write_pos - lo if lo else write_pos  # positions are never negative
    in_range = ((local >= 0) & (local < m) if lo else local < m)[:, None, None]
    slot = local.clamp(0, m - 1).long()
    cache_k[rows, slot] = torch.where(in_range, k_new[:, 0], cache_k[rows, slot])
    cache_v[rows, slot] = torch.where(in_range, v_new[:, 0], cache_v[rows, slot])
    return cache_k, cache_v


def _write_slot_on_mesh(cache_k: DTensor, cache_v: DTensor, k_new: DTensor, v_new: DTensor,
                        write_pos: DTensor) -> None:
    """``_write_slot`` on each rank's local shard of the caches, in their
    stored placements: the new K/V are placed as the cache is (an M shard
    of the cache needs the whole new row) and each rank writes the slots it
    holds."""
    mesh = cache_k.device_mesh
    cp = tuple(cache_k.placements)
    kp = tuple(Replicate() if p == Shard(1) else p for p in cp)
    wp = tuple(p if p == Shard(0) else Replicate() for p in cp)
    seq_dims = [i for i, p in enumerate(cp) if p == Shard(1)]

    def write(ck, cv, kn, vn, wpos):
        shard = 0
        coord = mesh.get_coordinate()
        for i in seq_dims:  # this rank's M shard, major to minor
            shard = shard * mesh.size(i) + coord[i]
        return _write_slot(ck, cv, kn, vn, wpos, lo=shard * ck.shape[1])

    SH.local_call(write, (cp, cp, kp, kp, wp), (cp, cp), cache_k, cache_v, k_new, v_new,
                  write_pos)


def attn_forward(p: Params, x: torch.Tensor, positions: torch.Tensor, cfg,
                 window: int = 0,
                 kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 causal: bool = True
                 ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Prefill / training attention.  Returns (out, (k, v)) for the cache.

    ``window`` > 0 limits causal self-attention to the last ``window`` keys
    (query i attends keys j with i - window < j <= i).  ``kv_override`` =
    (k source, v source) makes it cross-attention: a 4-D source (B,Sk,Hkv,D)
    is the K or V as it is, a 3-D one (B,Sk,d) is projected; rope is
    skipped.  ``causal=False`` attends every key.  As in the reference
    (layers.py:204-213), K1 (``"pallas"``) takes only causal self-attention
    with no window, and ``"blockwise"`` / ``"blockwise_u"`` causal
    self-attention with or without a window (``_blockwise_attention``); the
    rest runs the plain path, so a windowed prefill launches no K1 even when
    the prompt fits in the window."""
    impl = cfg.attention_impl
    _check_impl(impl)
    q = _project(x, p["wq"])
    if kv_override is None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(_project(x, p["wk"]), positions, cfg.rope_theta)
        v = _project(x, p["wv"])
    else:
        src_k, src_v = kv_override
        k = src_k if src_k.dim() == 4 else _project(src_k, p["wk"])
        v = src_v if src_v.dim() == 4 else _project(src_v, p["wv"])
    self_causal = kv_override is None and causal
    if impl == "pallas" and self_causal and window == 0:
        # K1: the CUDA flash-attention kernel for CUDA tensors, its plain
        # version for CPU tensors
        out = _flash(q, k, v)
    elif impl in ("blockwise", "blockwise_u") and self_causal:
        out = _blockwise_attention(_maybe_seq_shard(q, cfg), k, v, cfg, window)
    else:
        mask = None
        if self_causal:
            q = _maybe_seq_shard(q, cfg)
            iq = SH.replicate_like(torch.arange(q.shape[1], device=x.device)[:, None], q)
            ik = SH.replicate_like(torch.arange(k.shape[1], device=x.device)[None, :], q)
            mask = ik <= iq
            if window > 0:
                mask = mask & (ik > iq - window)
        out = _plain_attention(q, k, v, mask, cfg)
    return _out_project(out, p["wo"]), (k, v)


def attn_decode(p: Params, x: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
                pos: torch.Tensor, cfg, write_pos: Optional[torch.Tensor] = None,
                cross: bool = False
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Single-token decode.  x: (B,1,d); cache_{k,v}: (B,M,Hkv,D), UPDATED IN
    PLACE and returned.

    ``pos`` (B,) is the absolute position of the new token: it drives RoPE
    and the valid-length mask, min(pos + 1, M).  ``write_pos`` (B,) is the
    slot written, ``pos`` by default; a circular sliding-window buffer passes
    ``pos % M``.  A slot >= M writes nothing, as the reference's one-hot
    blend does.  With ``cross=True`` the
    cache is the fixed encoder K/V: nothing is written, no rope, every slot
    is attended, on the plain path (layers.py:271 of the reference).  Only
    ``"pallas"`` takes a kernel (K2); ``"blockwise"`` decodes on the plain
    path, as in the reference."""
    impl = cfg.attention_impl
    _check_impl(impl)
    q = _project(x, p["wq"])
    if cross:
        out = _plain_attention(q, cache_k, cache_v, None, cfg)
        return _out_project(out, p["wo"]), (cache_k, cache_v)
    m = cache_k.shape[1]
    q = apply_rope(q, pos[:, None], cfg.rope_theta)
    k_new = apply_rope(_project(x, p["wk"]), pos[:, None], cfg.rope_theta)
    v_new = _project(x, p["wv"])
    if write_pos is None:
        write_pos = pos
    if isinstance(cache_k, DTensor):
        _write_slot_on_mesh(cache_k, cache_v, k_new, v_new, write_pos)
    else:
        _write_slot(cache_k, cache_v, k_new, v_new, write_pos)
    valid = torch.clamp(pos + 1, max=m).to(torch.int32)
    if impl == "pallas":
        # K2: the CUDA flash-decode kernel (plain version on the CPU)
        out = _flash_decode(q, cache_k, cache_v, valid)
    else:
        ar = SH.replicate_like(torch.arange(m, device=x.device), valid)
        mask = ar[None, :] < valid[:, None]  # (B,M)
        out = _plain_attention(q, cache_k, cache_v, mask[:, None, None, None, :], cfg)
    return _out_project(out, p["wo"]), (cache_k, cache_v)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def mlp_defs(cfg, d_ff: Optional[int] = None) -> Params:
    d, dff = cfg.d_model, d_ff or cfg.d_ff
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
        # (in bf16, sqrt(2048) becomes 45.25); made on the device, with no
        # copy from the host
        x = x * torch.full((), math.sqrt(cfg.d_model), dtype=x.dtype, device=x.device)
    return x


def unembed(p: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x, p["embedding"])
    return torch.einsum("bsd,dv->bsv", x, p["lm_head"])


def posembed_defs(cfg, max_len: int) -> Params:
    """A learned absolute position table (max_len, d_model)."""
    return {
        "pos": ParamDef((max_len, cfg.d_model), (None, "embed"), init="embed", scale=0.02,
                        dtype=adtype(cfg))
    }
