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
runs them in XLA, outside any Pallas kernel).  The expert-parallel routes
(``"ep_shard_map"``, ``"ep_gather"``) are ``parallel/ep.py``'s: they need
the mesh a step installs, and raise the reference's ``RuntimeError``
without one.

On a mesh (DTensor params and activations, ``steps.py``) ``"dropping"``
places the experts over "model" as the reference's GSPMD partitioner does.
The router's logits, sharded over E, are gathered whole before the top-k.
The dispatch and the expert FFNs run in one ``local_map`` island a rank
(``_dispatch_on_mesh``): the rank's batch rows whole, the same slots as
``queue_slots`` gives over every expert, only its own experts run, and the
f32 combine of their picks is a ``Partial`` sum over "model", reduced once
(``sharding.relayout.reduced_bytes``) before the cast.  Where the rules
leave the expert dim whole (E not divisible by "model") every rank runs
every expert and nothing is reduced.  ``"dense"`` gathers its experts whole
(``relayout.gathered_bytes``).  The load-balance loss is a mean over the
whole batch, as under the reference's pjit.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch import sharding as SH
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
    if isinstance(logits, DTensor):  # E whole (and summed) for the top-k
        logits = SH.relayout(logits, [Replicate() if pl == Shard(2) or pl.is_partial() else pl
                                      for pl in logits.placements])
    probs = torch.softmax(logits, dim=-1)
    gates, idx = _top_k(probs, cfg.moe.top_k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)  # renormalise
    return probs, gates, idx


def _top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the top ``k`` over the last dim.  On a mesh (E
    whole) each rank takes its local rows' top-k in a ``local_map`` island:
    DTensor's own topk builds a plain tensor in its backward."""
    if not isinstance(probs, DTensor):
        return torch.topk(probs, k, dim=-1)
    pl = tuple(probs.placements)
    return SH.local_call(lambda p: tuple(torch.topk(p, k, dim=-1)), (pl,), (pl, pl), probs)


def aux_load_balance_loss(probs: torch.Tensor, idx: torch.Tensor, n_experts: int
                          ) -> torch.Tensor:
    """Switch-style load-balancing loss: n_experts * sum(mean prob * mean
    assignment), the assignment one-hot over the real experts."""
    me = probs.mean(dim=(0, 1))  # (E,)
    experts = SH.replicate_like(torch.arange(n_experts, device=idx.device), idx)
    assign = (idx[..., None] == experts).float().sum(2)  # (B,S,E), one-hot over k summed
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


def _expert_keys(p: Params) -> Tuple[str, ...]:
    return ("w1", "w2", "w3") if "w3" in p else ("w1", "w2")


def moe_dense(p: Params, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    probs, gates, idx = _router(p, x, cfg)
    m = cfg.moe
    keys = _expert_keys(p)
    w = {k: p[k] if not isinstance(p[k], DTensor)
         else SH.relayout(p[k], [Replicate()] * p[k].device_mesh.ndim) for k in keys}
    all_out = torch.stack([apply_mlp({k: w[k][e] for k in keys}, x, cfg.activation)
                           for e in range(m.n_experts)])  # (E,B,S,d)
    experts = SH.replicate_like(torch.arange(m.n_experts, device=idx.device), idx)
    combine = ((idx[..., None] == experts).float() * gates[..., None]).sum(2)  # (B,S,E)
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


def _dispatch(p: Params, x: torch.Tensor, gates: torch.Tensor, idx: torch.Tensor, cfg,
              lo: int = 0) -> torch.Tensor:
    """The capacity dispatch, the expert FFNs and the combine, in f32 (B,S,d),
    of the pairs routed to experts ``lo`` .. ``lo`` + E' - 1, the E' experts
    whose weights ``p`` holds; the slots are those of the whole expert set.
    Each batch row is a group."""
    b, s, d = x.shape
    m = cfg.moe
    e, c = p["w1"].shape[0], capacity(s, m)
    pos, keep = queue_slots(idx, c, m.e_pad)  # over the padded count (never routed to)
    local = idx - lo
    mine = keep & (local >= 0) & (local < e) if e < m.e_pad else keep
    # each kept pair's slot, expert-major: expert i's slots of group g are
    # rows (i*B + g)*C onwards; a dropped pair's goes to a spare last row
    group = torch.arange(b, device=x.device)[:, None, None]
    slot = torch.where(mine, (local * b + group) * c + pos, e * b * c).reshape(-1)
    # each slot's token row; an empty slot's is b*s, a row of zeros
    token = torch.arange(b * s, device=x.device).repeat_interleave(m.top_k)
    src = torch.full((e * b * c + 1,), b * s, device=x.device).scatter(0, slot, token)
    xz = torch.cat([x.reshape(b * s, d), x.new_zeros(1, d)])
    out_e = _expert_ffn(p, xz[src[:-1]].reshape(e, b * c, d), cfg.activation)
    # combine: gates rounded to the activation dtype, summed in f32
    w = (gates.to(x.dtype).float() * mine).reshape(-1, 1)
    picked = out_e.reshape(e * b * c, d)[torch.where(mine.reshape(-1), slot, 0)]
    return (w * picked.float()).reshape(b, s, m.top_k, d).sum(2)


def _dispatch_on_mesh(p: Params, x: DTensor, gates: DTensor, idx: DTensor, cfg
                      ) -> DTensor:
    """``_dispatch`` in one ``local_map`` island a rank: x, gates and idx
    with the batch over the dp axes (where it divides) and the rest whole,
    the expert weights with only their expert dim sharded (over "model"
    where the rules put it there).  Returns the f32 combine, a ``Partial``
    sum over "model" when the experts are sharded there, reduced to its
    replicated value here."""
    mesh = x.device_mesh
    keys = _expert_keys(p)
    act = SH.kernel_layout(mesh, ("dp" if x.shape[0] % SH.dp_size(mesh) == 0 else None,
                                  None, None))
    wpl = tuple(pl if pl == Shard(0) else Replicate() for pl in p["w1"].placements)
    split = [i for i, pl in enumerate(wpl) if pl == Shard(0)]  # the experts' mesh dims
    batch = [i for i, pl in enumerate(act) if pl == Shard(0)]  # the batch's mesh dims
    # each rank's grad is its share of the sum: over the expert dims for the
    # activations (its experts' pairs), over the batch dims for the weights
    # (its batch rows)
    act_grad = tuple(Partial() if i in split else pl for i, pl in enumerate(act))
    w_grad = tuple(Partial() if i in batch else pl for i, pl in enumerate(wpl))
    out_pl = tuple(Partial() if i in split else pl for i, pl in enumerate(act))

    def island(xl, gl, il, *ws):
        lo = 0
        for i in split:  # this rank's experts, major to minor
            lo = lo * mesh.size(i) + mesh.get_coordinate()[i]
        w = dict(zip(keys, ws))
        return _dispatch(w, xl, gl, il, cfg, lo * w["w1"].shape[0])

    out = SH.local_call(island, (act, act, act) + (wpl,) * len(keys), out_pl,
                        x, gates, idx, *(p[k] for k in keys),
                        grad_pl=(act_grad, act_grad, act) + (w_grad,) * len(keys))
    return SH.relayout(out, act)


def moe_dropping(p: Params, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-based dispatch; the groups are the batch rows."""
    probs, gates, idx = _router(p, x, cfg)
    if isinstance(x, DTensor):
        out = _dispatch_on_mesh(p, x, gates, idx, cfg)
    else:
        out = _dispatch(p, x, gates, idx, cfg)
    return out.to(x.dtype), aux_load_balance_loss(probs, idx, cfg.moe.n_experts)


def apply_moe(p: Params, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out (B,S,d) in x's dtype, aux f32 scalar)."""
    impl = cfg.moe.routing_impl
    if impl == "dense":
        out, aux = moe_dense(p, x, cfg)
    elif impl == "dropping":
        out, aux = moe_dropping(p, x, cfg)
    elif impl == "ep_shard_map":
        from repro_torch.parallel.ep import moe_ep_shard_map

        out, aux = moe_ep_shard_map(p, x, cfg)
    elif impl == "ep_gather":
        from repro_torch.parallel.ep import moe_ep_gather

        out, aux = moe_ep_gather(p, x, cfg)
    else:
        raise ValueError(impl)
    if cfg.moe.n_shared_experts:
        out = out + apply_mlp(p["shared"], x, cfg.activation)
    return out, aux
