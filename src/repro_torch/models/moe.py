"""Mixture-of-Experts layer: top-k router + expert FFNs.

Port of ``repro.models.moe``.  Two routing implementations
(``cfg.moe.routing_impl``) compute what their JAX counterparts compute:

- ``"dense"``: every expert on every token, combined by the gates in f32
  (tiny smoke configs and oracles only: O(E) compute);
- ``"dropping"`` (default): GShard-style capacity dispatch.  Each batch row
  is a group with ``capacity`` slots per expert; a (token, choice) pair
  takes the next slot of its expert's queue in token order, and pairs past
  the capacity are dropped.  The reference builds (B, S, E, C) one-hot
  dispatch and combine tensors and contracts them with einsums; here each
  slot gathers its token into an expert-major (E, B*C, d) buffer, the
  experts run as one batched product, and each token sums its pairs'
  outputs weighted by the gates: the same slots, the same drops and the
  same roundings, without the one-hot products.

The expert FFNs are plain batched products, as in the reference (which
runs them in XLA, outside any Pallas kernel).  The expert-parallel
implementations (``"ep_shard_map"``, ``"ep_gather"``) wait for distribution.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import adtype, apply_mlp, mlp_defs
from repro_torch.models.params import ParamDef

Params = Dict[str, Any]


def moe_defs(cfg) -> Params:
    m = cfg.moe
    d, dff, e = cfg.d_model, m.d_ff_expert, m.n_experts
    ep = m.e_pad  # weights padded to a mesh-divisible expert count
    dt = adtype(cfg)
    defs: Params = {
        # the router is f32 in every model, a bf16 one too
        "router": ParamDef((d, e), ("embed", "expert"), dtype=torch.float32),
        "w1": ParamDef((ep, d, dff), ("expert", "embed", "mlp"), dtype=dt),
        "w2": ParamDef((ep, dff, d), ("expert", "mlp", "embed"), dtype=dt),
    }
    if cfg.activation in ("swiglu", "geglu"):
        defs["w3"] = ParamDef((ep, d, dff), ("expert", "embed", "mlp"), dtype=dt)
    if m.n_shared_experts:
        defs["shared"] = mlp_defs(cfg, d_ff=m.d_ff_expert * m.n_shared_experts)
    return defs


def _router(p: Params, x: torch.Tensor, cfg
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B,S,d) -> (probs (B,S,E) f32, gates (B,S,k) f32, idx (B,S,k)).

    The logits are an f32 product; on the card it must not run in TF32,
    whose 10-bit mantissa would move the top-k choice of near-tied tokens."""
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the MoE router's f32 matmul would run in TF32: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    logits = x.float() @ p["router"]  # (B,S,E)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, cfg.moe.top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)  # renormalise
    return probs, gates, idx


def aux_load_balance_loss(probs: torch.Tensor, idx: torch.Tensor, n_experts: int
                          ) -> torch.Tensor:
    """Switch-style load-balancing loss: n_experts * sum(mean prob * mean
    assignment), the assignment one-hot over the real experts."""
    me = probs.mean(dim=(0, 1))  # (E,)
    assign = F.one_hot(idx, n_experts).float().sum(2)  # (B,S,E)
    ce = assign.mean(dim=(0, 1))
    ce = ce / torch.clamp(ce.sum(), min=1e-9)
    return n_experts * torch.sum(me * ce)


def _expert_ffn(p: Params, h: torch.Tensor, activation: str) -> torch.Tensor:
    """h: (E,C,d) -> (E,C,d), batched over experts."""
    u = torch.bmm(h, p["w1"])
    # jax.nn.gelu defaults to the tanh approximation
    if activation == "swiglu":
        u = F.silu(u) * torch.bmm(h, p["w3"])
    elif activation == "geglu":
        u = F.gelu(u, approximate="tanh") * torch.bmm(h, p["w3"])
    elif activation == "relu2":
        u = torch.square(F.relu(u))
    else:
        u = F.gelu(u, approximate="tanh")
    return torch.bmm(u, p["w2"])


def moe_dense(p: Params, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    probs, gates, idx = _router(p, x, cfg)
    m = cfg.moe
    keys = ("w1", "w2", "w3") if "w3" in p else ("w1", "w2")
    all_out = torch.stack([apply_mlp({k: p[k][e] for k in keys}, x, cfg.activation)
                           for e in range(m.n_experts)])  # (E,B,S,d)
    combine = (F.one_hot(idx, m.n_experts).float() * gates[..., None]).sum(2)  # (B,S,E)
    out = torch.einsum("ebsd,bse->bsd", all_out.float(), combine).to(x.dtype)
    return out, aux_load_balance_loss(probs, idx, m.n_experts)


def capacity(s: int, moe) -> int:
    """Slots per expert in a group of ``s`` tokens: max(int(s k cf / E), 1),
    rounded up to a multiple of 8."""
    c = max(int(s * moe.top_k * moe.capacity_factor / moe.n_experts), 1)
    return (c + 7) // 8 * 8


def queue_slots(idx: torch.Tensor, n_slots: int, e_pad: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pos, keep) of each (token, choice) pair, both (B,S,k): ``pos`` is the
    number of pairs before it in its group (token-major order) that chose
    the same expert, ``keep`` is ``pos < n_slots``."""
    b, s, k = idx.shape
    flat = idx.reshape(b, 1, s * k)
    # (B,E,S*k) one-hot, the pairs on the inner dim, where a scan is fast
    onehot = torch.arange(e_pad, device=idx.device)[None, :, None] == flat
    before = onehot.cumsum(-1, dtype=torch.int32) - onehot.int()  # exclusive count
    pos = before.gather(1, flat).reshape(b, s, k)
    return pos, pos < n_slots


def moe_dropping(p: Params, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-based dispatch; the groups are the batch rows."""
    b, s, d = x.shape
    m = cfg.moe
    probs, gates, idx = _router(p, x, cfg)
    e, c = m.e_pad, capacity(s, m)  # slots over the padded count (never routed to)
    pos, keep = queue_slots(idx, c, e)
    # each kept pair's slot, expert-major: expert i's slots of group g are
    # rows (i*B + g)*C onwards; a dropped pair's goes to a spare last row
    group = torch.arange(b, device=x.device)[:, None, None]
    slot = torch.where(keep, (idx * b + group) * c + pos, e * b * c).reshape(-1)
    # each slot's token row; an empty slot's is b*s, a row of zeros
    token = torch.arange(b * s, device=x.device).repeat_interleave(m.top_k)
    src = torch.full((e * b * c + 1,), b * s, device=x.device).scatter(0, slot, token)
    xz = torch.cat([x.reshape(b * s, d), x.new_zeros(1, d)])
    out_e = _expert_ffn(p, xz[src[:-1]].reshape(e, b * c, d), cfg.activation)
    # combine: gates rounded to the activation dtype, summed in f32
    w = (gates.to(x.dtype).float() * keep).reshape(-1, 1)
    picked = out_e.reshape(e * b * c, d)[torch.where(keep.reshape(-1), slot, 0)]
    out = (w * picked.float()).reshape(b, s, m.top_k, d).sum(2).to(x.dtype)
    return out, aux_load_balance_loss(probs, idx, m.n_experts)


def apply_moe(p: Params, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out (B,S,d) in x's dtype, aux f32 scalar)."""
    impl = cfg.moe.routing_impl
    if impl == "dense":
        out, aux = moe_dense(p, x, cfg)
    elif impl == "dropping":
        out, aux = moe_dropping(p, x, cfg)
    elif impl in ("ep_shard_map", "ep_gather"):
        raise NotImplementedError(
            f"routing_impl={impl!r} is expert parallelism, which waits for ROADMAP.md "
            "Queue 1 item 5b; the port has 'dense' and 'dropping'")
    else:
        raise ValueError(impl)
    if cfg.moe.n_shared_experts:
        out = out + apply_mlp(p["shared"], x, cfg.activation)
    return out, aux
