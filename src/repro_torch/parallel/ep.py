"""Expert parallelism by hand (port of ``repro.parallel.ep``).

Two MoE routes of the reference, both on the mesh that the step builders
install while they run (``ep_mesh(mesh)``; the model code finds it with
``current_mesh()``, as ``attention_partitioning="seq"`` in
``models/layers.py`` does):

- ``moe_ep_shard_map`` (``routing_impl="ep_shard_map"``): each rank builds
  the one-hot (B, S, E_loc, C) ``dispatch`` and ``combine`` tensors of its
  own E_loc = E_pad / model experts only, in x's dtype, and contracts them
  with einsums as the reference does;
- ``moe_ep_gather`` (``routing_impl="ep_gather"``): the same slots, with
  the dispatch a gather of x's rows times ``slot_use`` and the combine a
  gather of the experts' rows weighted by ``(gates * keep)`` in x's dtype,
  summed over each token's k picks in x's dtype.

Layouts (the reference's ``in_specs`` / ``out_specs``), on torch.distributed
as one ``sharding.local_call`` island a rank, whose ``grad_pl`` make both
routes train:

- x has its batch over the dp axes where it divides, else is replicated,
  and every other dim whole; tokens are thus replicated over "model";
- the router is replicated and runs inside the island on the rank's own
  rows (the ``"dropping"`` route on a mesh gathers its logits whole
  first);
- w1, w2 (and w3) are ``Shard(0)`` over "model": ``E_pad // model``
  experts a rank.  Padded experts (``n_experts_padded``) are never routed
  to, so a rank that holds only pads contributes zeros;
- each rank's output is its experts' partial sum in x's dtype, a
  ``Partial`` over "model", reduced once (the reference's ``psum`` of
  partials in x's dtype);
- aux is ``aux_load_balance_loss`` of the rank's own rows, then averaged
  over the dp axes where the batch is split there (the reference's
  ``pmean``): the mean of the groups' statistics, not the whole batch's.
  Every rank of "model" computes the same aux, so each contributes an
  equal share of it to one reduction: its grad, like the output's, is
  then counted once in the router's and x's grads, which are partial sums
  over "model".

Refusals, as in the reference: with no mesh installed, or one with no
"model" axis, a ``RuntimeError`` with the reference's message (every
``mesh=None`` path, the engine's included: it is the reference's
behaviour, not a fallback to ``"dropping"``); a ``ValueError`` when E_pad
is not a multiple of "model".

The expert FFNs are plain batched products, as in the reference (which
runs them in XLA, outside any Pallas kernel).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch import sharding as SH
from repro_torch.models.moe import (_expert_ffn, _router, aux_load_balance_loss, capacity,
                                    queue_slots)

_state = threading.local()


@contextlib.contextmanager
def ep_mesh(mesh: Any):
    prev = getattr(_state, "mesh", None)
    _state.mesh = mesh
    try:
        yield
    finally:
        _state.mesh = prev


def current_mesh() -> Optional[Any]:
    return getattr(_state, "mesh", None)


def _local_routing(router: torch.Tensor, x_l: torch.Tensor, cfg, e: int, n_model: int,
                   midx: int):
    """The routing of one rank's rows x_l (B_l,S,d) for its experts
    ``midx * e_loc`` onwards: (probs, gates, idx, lidx_c, pos, keep,
    capacity, e_loc).  ``pos`` is a pair's place in its expert's queue,
    ``keep`` marks the pairs routed to this rank's experts within their
    capacity (``models/moe.capacity``: the reference's ``_capacity``),
    ``lidx_c`` a pair's local expert (clipped)."""
    e_loc = e // n_model
    c = capacity(x_l.shape[1], cfg.moe)
    probs, gates, idx = _router({"router": router}, x_l, cfg)
    lidx = idx - midx * e_loc
    mine = (lidx >= 0) & (lidx < e_loc)
    pos, fits = queue_slots(idx, c, e)  # a mine pair's queue is its local expert's
    return probs, gates, idx, lidx.clamp(0, e_loc - 1), pos, fits & mine, c, e_loc


def _ep_gather_local(cfg, e: int, n_model: int, midx: int, x_l: torch.Tensor,
                     router: torch.Tensor, w: Dict[str, torch.Tensor]):
    bl, s, d = x_l.shape
    k = cfg.moe.top_k
    probs, gates, idx, lidx_c, pos, keep, c, e_loc = _local_routing(
        router, x_l, cfg, e, n_model, midx)
    # slot -> token: each kept pair writes its token into (row, expert, pos);
    # the others go to a spare slot C, cut afterwards (the reference's
    # out-of-range scatter, dropped)
    pos_eff = torch.where(keep, pos, c)
    brow = torch.arange(bl, device=x_l.device)[:, None, None]
    flat = ((brow * e_loc + lidx_c) * (c + 1) + pos_eff).reshape(-1)
    tok = torch.arange(s, device=x_l.device)[None, :, None].expand(bl, s, k).reshape(-1)
    slot_tok = torch.zeros(bl * e_loc * (c + 1), dtype=torch.long, device=x_l.device)
    slot_tok = slot_tok.scatter(0, flat, tok).reshape(bl, e_loc, c + 1)[..., :c]
    slot_use = torch.zeros(bl * e_loc * (c + 1), dtype=x_l.dtype, device=x_l.device)
    slot_use = slot_use.scatter(0, flat, torch.ones_like(tok, dtype=x_l.dtype))
    slot_use = slot_use.reshape(bl, e_loc, c + 1)[..., :c]
    # gather dispatch: (B_l, E_loc, C, d) -> expert-major (E_loc, B_l*C, d)
    rows = torch.arange(bl, device=x_l.device)[:, None, None]
    h = x_l[rows, slot_tok] * slot_use[..., None]
    h = h.transpose(0, 1).reshape(e_loc, bl * c, d)
    out_e = _expert_ffn(w, h, cfg.activation).reshape(e_loc, bl, c, d).transpose(0, 1)
    # gather combine: each pair's slot row, weighted in x's dtype
    y_sk = out_e[brow, lidx_c, pos_eff.clamp(max=c - 1)]  # (B_l,S,k,d)
    wgt = (gates * keep.to(gates.dtype)).to(x_l.dtype)
    y = torch.einsum("bsk,bskd->bsd", wgt, y_sk)
    return y, aux_load_balance_loss(probs, idx, cfg.moe.n_experts)


def _ep_shard_map_local(cfg, e: int, n_model: int, midx: int, x_l: torch.Tensor,
                        router: torch.Tensor, w: Dict[str, torch.Tensor]):
    bl, s, d = x_l.shape
    probs, gates, idx, lidx_c, pos, keep, c, e_loc = _local_routing(
        router, x_l, cfg, e, n_model, midx)
    dt = x_l.dtype
    # one-hot over the local experts; a pair of another rank's is not kept
    oh_f = (lidx_c[..., None] == torch.arange(e_loc, device=x_l.device)).to(dt)  # (B,S,k,El)
    slots = torch.arange(c, device=x_l.device)
    kept = ((pos[..., None] == slots) & keep[..., None]).to(dt)  # (B,S,k,C)
    dispatch = torch.einsum("bske,bskc->bsec", oh_f, kept)
    combine = torch.einsum("bsk,bske,bskc->bsec", gates.to(dt), oh_f, kept)
    h = torch.einsum("bsec,bsd->ebcd", dispatch, x_l).reshape(e_loc, bl * c, d)
    out_e = _expert_ffn(w, h, cfg.activation).reshape(e_loc, bl, c, d)
    y = torch.einsum("bsec,ebcd->bsd", combine, out_e)
    return y, aux_load_balance_loss(probs, idx, cfg.moe.n_experts)


def _moe_ep(p: Dict[str, Any], x: torch.Tensor, cfg, local, refusal: str,
            uneven: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The island that both routes share: ``local(cfg, e, n_model, midx,
    x_l, router, w)`` on each rank's rows and experts."""
    mesh = current_mesh()
    if mesh is None or "model" not in SH.mesh_shape(mesh):
        raise RuntimeError(refusal)
    n_model = SH.mesh_shape(mesh)["model"]
    e = cfg.moe.e_pad  # padded expert count (pads are never routed to)
    if e % n_model != 0:
        raise ValueError(uneven.format(e=e, n=n_model))
    if not isinstance(x, DTensor):
        raise TypeError("the expert-parallel routes take DTensors on the installed mesh "
                        "(the step bundles of steps.py place them)")
    keys = ("w1", "w2", "w3") if "w3" in p else ("w1", "w2")
    dpsz = SH.dp_size(mesh)
    act = SH.kernel_layout(mesh, ("dp" if x.shape[0] % dpsz == 0 and dpsz > 1 else None,
                                  None, None))
    mdim = list(SH.mesh_shape(mesh)).index("model")
    wpl = SH.kernel_layout(mesh, ("model", None, None))
    rep = (Replicate(),) * mesh.ndim
    batch = [i for i, pl in enumerate(act) if pl == Shard(0)]  # the batch's mesh dims
    split = [i for i, pl in enumerate(wpl) if pl == Shard(0)]  # the experts' (model, > 1)
    # each rank's grad is its share of a sum: the activations' and the
    # router's over the experts' mesh dim (its experts' pairs), the weights'
    # and the router's over the batch's (its rows)
    x_grad = tuple(Partial() if i in split else pl for i, pl in enumerate(act))
    r_grad = tuple(Partial() if i in split + batch else pl for i, pl in enumerate(rep))
    w_grad = tuple(Partial() if i in batch else pl for i, pl in enumerate(wpl))
    # aux: a share of the mean over the batch's mesh dims, and (every rank of
    # "model" computing the same rows' aux) an equal share over "model", so
    # that its grad reaches the router's and x's partial grads once
    shares = [i for i in range(mesh.ndim) if i in split + batch]
    n_shares = 1
    for i in shares:
        n_shares *= mesh.size(i)
    aux_pl = tuple(Partial() if i in shares else Replicate() for i in range(mesh.ndim))

    def island(xl, rl, *ws):
        y, aux = local(cfg, e, n_model, mesh.get_coordinate()[mdim], xl, rl,
                       dict(zip(keys, ws)))
        return y, aux / n_shares

    y, aux = SH.local_call(island, (act, rep) + (wpl,) * len(keys), (x_grad, aux_pl),
                           x, p["router"], *(p[k] for k in keys),
                           grad_pl=(x_grad, r_grad) + (w_grad,) * len(keys))
    return SH.relayout(y, act), SH.relayout(aux, rep)


def moe_ep_gather(p: Dict[str, Any], x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """EP with a gather dispatch and a gather combine (zero matmul FLOPs to
    move tokens): (out (B,S,d) in x's dtype, aux f32 scalar)."""
    return _moe_ep(p, x, cfg, _ep_gather_local, "ep_gather requires ep_mesh(mesh)",
                   "n_experts(_padded) {e} % model={n}")


def moe_ep_shard_map(p: Dict[str, Any], x: torch.Tensor, cfg
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """EP with the one-hot dispatch and combine einsums of each rank's
    experts: (out (B,S,d) in x's dtype, aux f32 scalar)."""
    return _moe_ep(p, x, cfg, _ep_shard_map_local,
                   "ep_shard_map requires ep_mesh(mesh) with a 'model' axis; use "
                   "routing_impl='dropping' locally",
                   "n_experts(_padded) {e} not divisible by model={n}")
