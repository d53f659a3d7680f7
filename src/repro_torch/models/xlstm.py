"""xLSTM blocks: mLSTM (matrix memory, parallel train form + O(1) decode) and
sLSTM (scalar memory, sequential recurrence with exponential gating).

Port of ``repro.models.xlstm`` (arXiv:2405.04517).  The mLSTM's training and
prefill form is the stabilised quadratic one; decode carries (C, n, m) and
the conv's last 3 inputs.  sLSTM blocks run strictly in sequence over time
(a Python loop stands in for ``lax.scan``), with block-diagonal recurrent
weights per head and a small post-FFN.  No kernel is involved, in the port
or in the reference.

Every state leaf is batch-first: the mLSTM's C (B,H,dh,dh), n (B,H,dh) and
m (B,H) in f32 and conv (B,3,dp) in the activation dtype; the sLSTM's c, n,
h and m (B,H,dh) in f32.  The mLSTM block returns its output without the
residual (the caller adds it); the sLSTM block adds its own residual and its
post-FFN.

On a mesh (DTensor params and activations) the device-made constants are
replicated DTensors (``sharding.replicate_like``) and an initial state is
born with the placements ``sharding.cache_pspecs`` gives its leaf (pass
``mesh``), each rank allocating its shard.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch import sharding as SH
from repro_torch.models.layers import adtype, apply_norm, norm_defs
from repro_torch.models.params import ParamDef
from repro_torch.models.ssm import _causal_conv

Params = Dict[str, Any]
State = Dict[str, torch.Tensor]


def _logsigmoid(x: torch.Tensor) -> torch.Tensor:
    return -F.softplus(-x)


# ---------------------------------------------------------------------------
# mLSTM block
# ---------------------------------------------------------------------------


def mlstm_defs(cfg) -> Params:
    d = cfg.d_model
    dp = int(cfg.xlstm.proj_factor * d)
    h = cfg.n_heads
    dh = dp // h
    dt = adtype(cfg)
    return {
        "norm": norm_defs(cfg),
        "w_up": ParamDef((d, dp), ("embed", "inner"), dtype=dt),
        "w_gate": ParamDef((d, dp), ("embed", "inner"), dtype=dt),
        "conv_w": ParamDef((4, dp), (None, "inner"), init="scaled", scale=0.5, dtype=dt),
        "conv_b": ParamDef((dp,), ("inner",), init="zeros", dtype=dt),
        "w_q": ParamDef((dp, h, dh), ("inner", "heads", "head_dim"), dtype=dt),
        "w_k": ParamDef((dp, h, dh), ("inner", "heads", "head_dim"), dtype=dt),
        "w_v": ParamDef((dp, h, dh), ("inner", "heads", "head_dim"), dtype=dt),
        "w_i": ParamDef((d, h), ("embed", "heads"), dtype=torch.float32),
        "b_i": ParamDef((h,), ("heads",), init="zeros", dtype=torch.float32),
        "w_f": ParamDef((d, h), ("embed", "heads"), dtype=torch.float32),
        "b_f": ParamDef((h,), ("heads",), init="ones", dtype=torch.float32),
        "w_down": ParamDef((dp, d), ("inner", "embed"), dtype=dt),
    }


def _split_heads(y: torch.Tensor, h: int) -> torch.Tensor:
    """y (B,S,H*dh) -> (B,S,H,dh).  On a mesh its last dim is first gathered
    where it is sharded over more ranks than H divides: the split into (H,
    dh) has no DTensor placement there (4 heads on a "model" axis of 16)."""
    if isinstance(y, DTensor):
        mesh = y.device_mesh
        y = SH.relayout(y, [Replicate() if p == Shard(2) and h % mesh.size(i) else p
                            for i, p in enumerate(y.placements)])
    return y.reshape(*y.shape[:2], h, y.shape[2] // h)


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B,S,dp) @ w (dp,H,dh) -> (B,S,H,dh), the einsum "bsd,dhk->bshk"."""
    dp, h, dh = w.shape
    return _split_heads(x @ w.reshape(dp, h * dh), h)


def _mlstm_qkvgates(p: Params, x: torch.Tensor, cfg, conv_state: Optional[torch.Tensor] = None):
    """(q, k, v (B,S,H,dh), ig, fg (B,S,H) f32 log-space gates, z (B,S,dp),
    conv state).  q and k come from silu(conv(u)), v from u itself; k is
    divided by sqrt(dh) cast to the activation dtype (19.625 in bf16 at
    dh = 384)."""
    xn = apply_norm(p["norm"], x, cfg.norm)
    u = xn @ p["w_up"]
    z = xn @ p["w_gate"]
    c, conv_state = _causal_conv(u, p["conv_w"], p["conv_b"], conv_state)
    c = F.silu(c)
    q = _heads(c, p["w_q"])
    scale = SH.replicate_like(torch.full((), math.sqrt(q.shape[-1]), dtype=torch.float32,
                                         device=c.device), c)
    k = _heads(c, p["w_k"]) / scale.to(c.dtype)
    v = _heads(u, p["w_v"])
    ig = xn.float() @ p["w_i"] + p["b_i"]
    fg = xn.float() @ p["w_f"] + p["b_f"]
    return q, k, v, ig, fg, z, conv_state


def mlstm_forward(p: Params, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, State]:
    """Parallel (training / prefill) form.  x: (B,S,d) -> (out (B,S,d), the
    decode state folded from the whole sequence).  ``out`` is without the
    residual."""
    q, k, v, ig, fg, z, conv_state = _mlstm_qkvgates(p, x, cfg)
    b, s, h, dh = q.shape
    fcum = torch.cumsum(_logsigmoid(fg), dim=1)  # (B,S,H)
    # log-decay matrix: D[i,j] = fcum_i - fcum_j + ig_j for j <= i, -inf above
    dmat = fcum[:, :, None, :] - fcum[:, None, :, :] + ig[:, None, :, :]  # (B,Si,Sj,H)
    idx = SH.replicate_like(torch.arange(s, device=x.device), dmat)
    causal = (idx[None, :] <= idx[:, None])[None, :, :, None]
    dmat = torch.where(causal, dmat, SH.replicate_like(
        torch.full((), float("-inf"), device=x.device), dmat))
    m = torch.clamp(dmat.amax(dim=2, keepdim=True), min=-1e30)  # guard all -inf rows
    dprime = torch.exp(dmat - m)
    scores = SH.batch_einsum("bihk,bjhk->bijh", q.float(), k.float())
    w = scores * dprime
    norm = torch.maximum(w.sum(dim=2).abs(), torch.exp(-m[:, :, 0]))  # (B,S,H)
    # contiguous operands: on a 16 x 16 mesh DTensor hands the einsum's view a
    # re-placed local shard whose strides it cannot view (torch 2.13)
    y = SH.batch_einsum("bijh,bjhk->bihk", w.contiguous(), v.float().contiguous()) / norm[..., None]
    y = SH.pin_grad((y.to(x.dtype) * _split_heads(F.silu(z), h)).reshape(b, s, h * dh), 2, h)
    state = _mlstm_state_from_seq(k, v, ig, fg, conv_state)
    return y @ p["w_down"], state


def _mlstm_state_from_seq(k: torch.Tensor, v: torch.Tensor, ig: torch.Tensor,
                          fg: torch.Tensor, conv_state: torch.Tensor) -> State:
    """Fold the whole sequence into (C, n, m) so decode can continue."""
    fcum = torch.cumsum(_logsigmoid(fg), dim=1)
    # weight of step j in the final state: exp(total - fcum_j + ig_j)
    logw = fcum[:, -1:, :] - fcum + ig  # (B,S,H)
    m = logw.amax(dim=1)  # (B,H)
    wgt = torch.exp(logw - m[:, None, :])
    kf, vf = k.float(), v.float()
    C = torch.einsum("bsh,bshd,bshe->bhde", wgt, kf, vf)
    n = torch.einsum("bsh,bshd->bhd", wgt, kf)
    return {"C": C, "n": n, "m": m, "conv": conv_state}


def mlstm_decode(p: Params, x: torch.Tensor, state: State, cfg
                 ) -> Tuple[torch.Tensor, State]:
    """O(1) recurrent step.  x: (B,1,d) -> (out (B,1,d) without the residual,
    new state); ``state`` is not written."""
    q, k, v, ig, fg, z, conv_state = _mlstm_qkvgates(p, x, cfg, state["conv"])
    b, _, h, dh = q.shape
    qf, kf, vf = (t[:, 0].float() for t in (q, k, v))
    ig1, logf = ig[:, 0], _logsigmoid(fg[:, 0])  # (B,H)
    m_new = torch.maximum(logf + state["m"], ig1)
    fprime = torch.exp(logf + state["m"] - m_new)[..., None]
    iprime = torch.exp(ig1 - m_new)[..., None]
    C = state["C"] * fprime[..., None] + iprime[..., None] * torch.einsum(
        "bhd,bhe->bhde", kf, vf)
    n = state["n"] * fprime + iprime * kf
    num = torch.einsum("bhde,bhd->bhe", C, qf)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", n, qf).abs(), torch.exp(-m_new))
    y = (num / den[..., None]).to(x.dtype)  # (B,H,dh)
    y = y.reshape(b, 1, h * dh) * F.silu(z)
    return y @ p["w_down"], {"C": C, "n": n, "m": m_new, "conv": conv_state}


def _state_leaf(shape, value: float, dtype: torch.dtype, device, mesh) -> torch.Tensor:
    """A state leaf filled with ``value``: on ``mesh`` a DTensor placed as
    ``sharding.cache_pspecs`` places its leaf, each rank making its shard."""
    if mesh is None:
        return torch.full(shape, value, dtype=dtype, device=device)
    return SH.filled(shape, value, dtype, device, mesh,
                     SH.placements(SH._auto_state_spec(shape, mesh), mesh))


def init_mlstm_state(cfg, batch: int, device="cuda", mesh=None) -> State:
    dp = int(cfg.xlstm.proj_factor * cfg.d_model)
    h = cfg.n_heads
    dh = dp // h
    f32 = dict(dtype=torch.float32, device=device, mesh=mesh)
    return {
        "C": _state_leaf((batch, h, dh, dh), 0.0, **f32),
        "n": _state_leaf((batch, h, dh), 0.0, **f32),
        "m": _state_leaf((batch, h), -1e30, **f32),
        "conv": _state_leaf((batch, 3, dp), 0.0, adtype(cfg), device, mesh),
    }


# ---------------------------------------------------------------------------
# sLSTM block
# ---------------------------------------------------------------------------


def slstm_defs(cfg) -> Params:
    d, h = cfg.d_model, cfg.n_heads
    dh = d // h
    dt = adtype(cfg)
    dffn = int(2 * d)
    return {
        "norm": norm_defs(cfg),
        # gate input projections: z, i, f, o
        "w_x": ParamDef((d, 4, h, dh), ("embed", None, "heads", "head_dim"),
                        dtype=torch.float32),
        # block-diagonal recurrent weights per head
        "r_h": ParamDef((4, h, dh, dh), (None, "heads", "head_dim", None), init="normal",
                        dtype=torch.float32),
        "b": ParamDef((4, h, dh), (None, "heads", "head_dim"), init="zeros",
                      dtype=torch.float32),
        "ffn_norm": norm_defs(cfg),
        "ffn_w1": ParamDef((d, dffn), ("embed", "mlp"), dtype=dt),
        "ffn_w2": ParamDef((dffn, d), ("mlp", "embed"), dtype=dt),
    }


def _slstm_cell(p: Params, xt: torch.Tensor, state: State) -> State:
    """One step.  xt: (B,4,H,dh), the pre-projected gate inputs z, i, f, o."""
    rec = torch.einsum("bhd,ghde->bghe", state["h"], p["r_h"])  # (B,4,H,dh)
    g = xt + rec + p["b"]
    zt = torch.tanh(g[:, 0])
    it = g[:, 1]  # log-space
    ft = _logsigmoid(g[:, 2])
    ot = torch.sigmoid(g[:, 3])
    m_new = torch.maximum(ft + state["m"], it)
    iprime = torch.exp(it - m_new)
    fprime = torch.exp(ft + state["m"] - m_new)
    c = fprime * state["c"] + iprime * zt
    n = fprime * state["n"] + iprime
    h = ot * c / torch.clamp(n, min=1e-6)
    return {"c": c, "n": n, "h": h, "m": m_new}


def slstm_forward(p: Params, x: torch.Tensor, cfg, state: Optional[State] = None
                  ) -> Tuple[torch.Tensor, State]:
    """Sequential over time.  x: (B,S,d) -> (x + cell + post-FFN (B,S,d), the
    state after the last step); ``state`` (default: the initial one) is not
    written."""
    b, s, d = x.shape
    xn = apply_norm(p["norm"], x, cfg.norm)
    xg = torch.einsum("bsd,dghe->bsghe", xn.float(), p["w_x"])  # (B,S,4,H,dh)
    if state is None:
        state = init_slstm_state(cfg, b, device=x.device,
                                 mesh=x.device_mesh if isinstance(x, DTensor) else None)
    hs = []
    for t in range(s):
        state = _slstm_cell(p, xg[:, t], state)
        hs.append(state["h"])
    y = SH.pin_grad(torch.stack(hs, dim=1).reshape(b, s, d), 2, cfg.n_heads).to(x.dtype)
    y = x + y  # residual around the cell
    yn = apply_norm(p["ffn_norm"], y, cfg.norm)
    # jax.nn.gelu defaults to the tanh approximation
    y = y + F.gelu(yn @ p["ffn_w1"], approximate="tanh") @ p["ffn_w2"]
    return y, state


def slstm_decode(p: Params, x: torch.Tensor, state: State, cfg) -> Tuple[torch.Tensor, State]:
    """``slstm_forward`` at S = 1 from the carried state."""
    return slstm_forward(p, x, cfg, state)


def init_slstm_state(cfg, batch: int, device="cuda", mesh=None) -> State:
    shape = (batch, cfg.n_heads, cfg.d_model // cfg.n_heads)
    f32 = dict(dtype=torch.float32, device=device, mesh=mesh)
    return {"c": _state_leaf(shape, 0.0, **f32), "n": _state_leaf(shape, 0.0, **f32),
            "h": _state_leaf(shape, 0.0, **f32), "m": _state_leaf(shape, -1e30, **f32)}
