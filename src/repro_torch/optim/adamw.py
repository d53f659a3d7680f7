"""AdamW written out by hand over nested-dict parameter trees, with a cosine
schedule and global-norm clipping.

Port of ``repro.optim.adamw`` (the ZeRO-1 state sharding, ``opt_pspecs``,
waits for distribution).  The arithmetic is the reference's:

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
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

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


def adamw_init(params: Any) -> Dict[str, Any]:
    """f32 zero moments beside each param, and the step counter at 0."""
    def zeros() -> Any:
        return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32, device=x.device),
                        params)

    step = torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)
    return {"mu": zeros(), "nu": zeros(), "step": step}


def adamw_update(grads: Any, state: Dict[str, Any], params: Any, cfg: AdamWConfig
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step.  Overwrites ``params``, the moments and ``grads`` in
    place (call it under ``torch.no_grad()``) and returns (params, state,
    {"grad_norm", "lr"})."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state["step"] + 1
    lr = cosine_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(b1, step.float())
    bc2 = 1 - torch.pow(b2, step.float())
    for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state["mu"]),
                          tree_leaves(state["nu"]), tree_leaves(params)):
        gf = g.float()
        m.mul_(b1).add_(gf, alpha=1 - b1)
        v.mul_(b2).addcmul_(gf, gf, value=1 - b2)
        del gf
        delta = (m / bc1).div_(torch.sqrt(v / bc2).add_(cfg.eps))
        pf = p.float()
        if p.is_floating_point():
            delta.add_(pf, alpha=cfg.weight_decay)
        p.copy_(pf.sub_(delta.mul_(lr)))
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, {"mu": state["mu"], "nu": state["nu"], "step": step}, metrics
