"""AdamW written out by hand over nested-dict parameter trees, with a cosine
schedule, global-norm clipping and ZeRO-1 optimizer-state sharding.

Port of ``repro.optim.adamw``.  The arithmetic is the reference's:

- the grads are clipped to ``grad_clip`` by their global norm (in f32) and
  cast back to their own dtype, so bf16 grads round-trip through bf16;
- the step counter is an int32 scalar tensor, incremented BEFORE the
  schedule reads it;
- the bias corrections ``1 - b ** step`` are computed in f32 tensors;
- weight decay applies to every floating leaf (norm scales and the
  embedding included);
- the moments are f32 and the update runs in f32, cast back to the param
  dtype.

Trees are walked in ``tree_leaves`` order (sorted keys, as JAX does).  The
update runs leaf by leaf and in place (params, moments and grads are
overwritten), so at full width it holds a few f32 temporaries of one leaf
at a time rather than of the whole tree.

On a mesh (the sharded train step, ``steps.make_train_step``) params, grads
and moments are DTensors.  ``opt_pspecs`` gives the moments' specs: the
param's own, plus under ZeRO-1 the data-parallel axes the param leaves free,
on its first unsharded dim they divide (``_zero1_spec``).  The step counter
and the schedule are replicated 0-d DTensors.  ``adamw_update`` re-places
explicitly, with ``sharding.relayout``:

- each grad, which autograd may leave ``Partial`` over the axes the batch is
  sharded on, is reduced once to its param's placements before the clipping
  (the all-reduce pjit inserts; bytes in ``relayout.reduced_bytes``);
- under ZeRO-1 each rank updates its shard of the moments from its slice of
  the grad and the param (a local slice: nothing moves), and the new param
  is gathered back to the param's placements (bytes in
  ``relayout.gathered_bytes``) and written in place.

Without a mesh the update is the one-device code above.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch import sharding as SH
from repro_torch.models.params import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr``, then a cosine decay to ``min_lr_ratio * lr``
    at ``total_steps``; an f32 scalar tensor."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                    0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree)))


def clip_by_global_norm(tree: Any, max_norm: float) -> Tuple[Any, torch.Tensor]:
    """Scale every leaf IN PLACE by min(1, max_norm / global norm), in f32 and
    rounded back to the leaf's dtype; returns (tree, global norm)."""
    g = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(g, min=1e-9), max=1.0)
    for x in tree_leaves(tree):
        x.copy_(x.float() * scale)
    return tree, g


def adamw_init(params: Any, specs: Any = None) -> Dict[str, Any]:
    """f32 zero moments beside each param, and the step counter at 0.  With
    DTensor params each moment is a DTensor of zeros, each rank allocating
    its shard alone, placed as its param or by ``specs`` (``opt_pspecs``'s
    tree) where given; the counter is replicated on the params' mesh."""
    first = tree_leaves(params)[0]
    if isinstance(first, DTensor):
        mesh = first.device_mesh

        def moment(x, spec=None) -> DTensor:
            pl = x.placements if spec is None else SH.placements(spec, mesh)
            return SH.filled(x.shape, 0, torch.float32, x.device, mesh, pl)

        def moments(key: str) -> Any:
            return SH.tree_map(moment, params, *([] if specs is None else [specs[key]]))

        step = SH.replicate_like(torch.zeros((), dtype=torch.int32, device=first.device), first)
        return {"mu": moments("mu"), "nu": moments("nu"), "step": step}

    def zeros() -> Any:
        return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32, device=x.device),
                        params)

    step = torch.zeros((), dtype=torch.int32, device=first.device)
    return {"mu": zeros(), "nu": zeros(), "step": step}


def adamw_update(grads: Any, state: Dict[str, Any], params: Any, cfg: AdamWConfig
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step.  Overwrites ``params``, the moments and ``grads`` in
    place (call it under ``torch.no_grad()``) and returns (params, state,
    {"grad_norm", "lr"}).  On a mesh the grads are first reduced to their
    params' placements (new DTensors: the given ones are left as they are)
    and each moment is updated in its own placements (module docstring)."""
    on_mesh = isinstance(tree_leaves(params)[0], DTensor)
    if on_mesh:
        grads = SH.tree_map(lambda g, p: SH.relayout(g, p.placements), grads, params)
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state["step"] + 1
    lr = cosine_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(b1, step.float())
    bc2 = 1 - torch.pow(b2, step.float())
    for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state["mu"]),
                          tree_leaves(state["nu"]), tree_leaves(params)):
        src = p
        if on_mesh and m.placements != p.placements:  # ZeRO-1: this rank's shard
            g, src = SH.relayout(g, m.placements), SH.relayout(p, m.placements)
        gf = g.float()
        m.mul_(b1).add_(gf, alpha=1 - b1)
        v.mul_(b2).addcmul_(gf, gf, value=1 - b2)
        del gf
        delta = (m / bc1).div_(torch.sqrt(v / bc2).add_(cfg.eps))
        pf = src.float()
        if p.is_floating_point():
            delta.add_(pf, alpha=cfg.weight_decay)
        new = pf.sub_(delta.mul_(lr))
        if src is not p:  # gather the updated shards back to the param's placements
            new = SH.relayout(new.to(p.dtype), p.placements)
        p.copy_(new)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, {"mu": state["mu"], "nu": state["nu"], "step": step}, metrics


# ---------------------------------------------------------------------------
# Optimizer-state sharding (ZeRO-1)
# ---------------------------------------------------------------------------


def _zero1_spec(shape: Tuple[int, ...], base: SH.P, mesh: Any) -> SH.P:
    """Add the data-parallel axes ``base`` leaves free to the first unsharded
    dim they divide (reference adamw.py:97)."""
    dp = SH.dp_axes(mesh)
    used = set()
    for e in base:
        if e is None:
            continue
        for a in (e if isinstance(e, tuple) else (e,)):
            used.add(a)
    free_dp = tuple(a for a in dp if a not in used)
    if not free_dp:
        return base
    size = SH._axis_size(mesh, free_dp)
    entries = list(base) + [None] * (len(shape) - len(base))
    for i, (dim, e) in enumerate(zip(shape, entries)):
        if e is None and dim % size == 0:
            entries[i] = free_dp if len(free_dp) > 1 else free_dp[0]
            return SH.P(*entries)
    return base


def opt_pspecs(defs: Any, rules: Dict[str, Any], mesh: Any, zero1: bool = True) -> Any:
    """Specs of the ``adamw_init`` tree: {"mu", "nu": one spec a param,
    "step": P()} (reference adamw.py:118)."""
    def one(d) -> SH.P:
        base = SH.spec_for(d.shape, d.axes, rules, mesh)
        return _zero1_spec(d.shape, base, mesh) if zero1 else base

    mu = SH.tree_map(one, defs)
    return {"mu": mu, "nu": SH.tree_map(lambda x: x, mu), "step": SH.P()}
