"""GPipe-style pipeline parallelism over a mesh axis (port of
``repro.parallel.pipeline``), on torch.distributed.

The layer stack is split into ``n_stages`` stages, one per rank of the mesh
axis ``axis`` (default "pod"), and microbatches stream through them: a
forward-only GPipe loop of ``n_micro + n_stages - 1`` ticks.  At tick t
stage 0 takes microbatch t while any remain, every stage applies
``stage_fn`` to what it holds, the last stage records microbatch
t - n_stages + 1, and the activations move one stage downstream.  The last
stage's outputs are then summed over the axis, so every rank returns them.

The move is a point-to-point exchange (``batch_isend_irecv``) on the
axis's process group, inside an autograd function whose backward moves the
grads one stage upstream, so the loop differentiates, as the reference's
``ppermute`` does.  A rank's stage is its coordinate on the axis, a host
integer: no device value is read on the host.  As in the reference, the
stages' choices (stage 0's ingest, the last stage's outputs) are
selections on the device, so every rank's graph holds every move and runs
its backward in the same order.  The move after the last tick, whose
result no stage reads, is not made, and a single stage moves nothing (a
rotation by one of one stage is the identity).

A building block, as in the reference: no step wires it in
(``steps.py`` and ``sharding.make_rules`` know ``tp`` and ``fsdp_tp``).
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch import sharding as SH


def _shift(y: torch.Tensor, group, by: int) -> torch.Tensor:
    """``y`` of the rank ``by`` places upstream on ``group`` (ours goes ``by``
    places downstream)."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    out = torch.empty_like(y)
    ops = [dist.P2POp(dist.isend, y.contiguous(), dist.get_global_rank(group, (me + by) % n),
                      group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, (me - by) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _Rotate(torch.autograd.Function):
    """One stage downstream; the backward moves the grad one stage upstream."""

    @staticmethod
    def forward(ctx, y, group):
        ctx.group = group
        return _shift(y, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -1), None


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor], stage_params: Any,
                   x: torch.Tensor, mesh, axis: str = "pod", n_micro: int = None
                   ) -> torch.Tensor:
    """Run ``x`` through n_stages stages, each living on one rank of
    ``axis``; ``stage_fn`` is applied n_stages times in sequence overall.

    stage_params: a tree (dicts, lists) whose leaves have a leading n_stages
    dim, DTensors ``Shard(0)`` over ``axis`` of ``mesh`` (a ``DeviceMesh``),
    each rank taking ``p[0]`` of its shard.  x: (B, ...) with B divisible by
    n_micro (default n_stages), every rank holding the same rows (a
    replicated DTensor, or a plain tensor).  Returns the (B, ...) outputs on
    every rank, of x's kind."""
    adim = mesh.mesh_dim_names.index(axis)
    n_stages = mesh.size(adim)
    n_micro = n_micro or n_stages
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} % n_micro {n_micro}")
    sidx = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    params_l = SH.tree_map(lambda p: p.to_local()[0], stage_params)
    placed = isinstance(x, DTensor)
    if placed:  # each rank's grad of x is its share: stage 0's ingest
        x = x.to_local(grad_placements=[Partial() if i == adim else Replicate()
                                        for i in range(mesh.ndim)])
    micro = x.reshape(n_micro, b // n_micro, *x.shape[1:])
    n_ticks = n_micro + n_stages - 1
    buf = torch.zeros_like(micro[0])
    outs = []
    for t in range(n_ticks):
        # stage 0 ingests microbatch t while any remain; a selection on the
        # device, as the reference's where, so that every rank's graph holds
        # every move and every rank runs each move's backward, in step
        take = torch.full((), sidx == 0 and t < n_micro, device=buf.device)
        buf = torch.where(take, micro[min(t, n_micro - 1)], buf)
        y = stage_fn(params_l, buf)
        if t >= n_stages - 1:  # the last stage's y is microbatch t - n_stages + 1
            outs.append(y)
        if n_stages > 1 and t < n_ticks - 1:
            buf = _Rotate.apply(y, group)
    # only the last stage's outputs count (the others' are zeroed): summed over
    # the axis
    last = torch.full((), sidx == n_stages - 1, device=buf.device)
    local = torch.where(last, torch.stack(outs), torch.zeros_like(micro))
    pl = [Partial() if i == adim else Replicate() for i in range(mesh.ndim)]
    out = DTensor.from_local(local.reshape(b, *x.shape[1:]), mesh, pl, run_check=False)
    out = out.redistribute(mesh, [Replicate()] * mesh.ndim)
    return out if placed else out.to_local()


def stack_stage_params(layer_params: Any, n_stages: int) -> Any:
    """Reshape (L, ...) stacked layer params into (n_stages, L/n_stages, ...)."""
    def f(p):
        n_layers = p.shape[0]
        if n_layers % n_stages:
            raise ValueError(f"layers {n_layers} % stages {n_stages}")
        return p.reshape(n_stages, n_layers // n_stages, *p.shape[1:])

    return SH.tree_map(f, layer_params)
