"""Logical-axis -> mesh-axis sharding rules (t5x-style), with divisibility
fallbacks so one rule table serves every architecture.

Port of ``repro.sharding``, with the same rules and specs.  Param logical
axes used by the model defs:
  embed, heads, kv_heads, head_dim, mlp, vocab, expert, inner, layers, embed_out

Strategies:
  tp       - params sharded over "model" only, replicated over data (+pod)
  fsdp_tp  - additionally shard the "embed" axis over "data" (2-D weight
             sharding: DTensor gathers a weight where an op needs it whole)

A spec is a ``P``: one entry per tensor dim, each None, a mesh axis name or
a tuple of names, compared with JAX's ``PartitionSpec`` entry by entry.  The
rules read only the mesh's axis names and sizes, so ``mesh`` is anything
that has them: a ``DeviceMesh`` or a plain ``{name: size}`` layout such as
the production mesh ``{"data": 16, "model": 16}``, which no process group
need exist for.  ``placements`` turns a ``P`` into DTensor placements on a
``DeviceMesh`` (the reference's ``NamedSharding``), and ``distribute`` places
a tree of tensors by a tree of specs (what the reference gets from
``jit_sharded``'s ``in_shardings``).

Trees here are nested dicts and lists; a ``P`` and a tuple of placements are
leaves.  Nothing is initialised at import.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard


def _entry(e: Any) -> Any:
    """JAX's normal form of an entry: a 1-tuple is its name, () is None."""
    if isinstance(e, (list, tuple)):
        e = tuple(e)
        return None if not e else e[0] if len(e) == 1 else e
    return e


class P:
    """A partition spec: ``P(None, "model")``, ``P(("pod", "data"), None)``."""
    __slots__ = ("entries",)

    def __init__(self, *entries: Any) -> None:
        self.entries = tuple(_entry(e) for e in entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, P) and self.entries == other.entries

    def __hash__(self) -> int:
        return hash(self.entries)

    def __repr__(self) -> str:
        return f"P{self.entries!r}"


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the same places of ``rest``);
    dicts and lists are containers, everything else a leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def mesh_shape(mesh: Any) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of a plain layout."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def dp_axes(mesh: Any) -> Tuple[str, ...]:
    """Data-parallel mesh axes: ("pod","data") on the multi-pod mesh."""
    return tuple(a for a in mesh_shape(mesh) if a in ("pod", "data"))


def dp_size(mesh: Any) -> int:
    """Ranks over the data-parallel axes together."""
    return _axis_size(mesh, dp_axes(mesh))


def make_rules(mesh: Any, strategy: str = "tp") -> Dict[str, Any]:
    rules: Dict[str, Any] = {
        "layers": None,
        "embed": None,
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "mlp": "model",
        "vocab": "model",
        "expert": "model",
        "inner": "model",
        "embed_out": None,
    }
    if strategy == "fsdp_tp":
        rules["embed"] = "data"
    elif strategy != "tp":
        raise ValueError(strategy)
    return rules


def _axis_size(mesh: Any, axis: Any) -> int:
    if axis is None:
        return 1
    shape = mesh_shape(mesh)
    if isinstance(axis, tuple):
        return math.prod(shape[a] for a in axis)
    return shape[axis]


def spec_for(shape: Sequence[int], axes: Sequence[Optional[str]], rules: Dict[str, Any],
             mesh: Any) -> P:
    """Resolve one param's spec, dropping non-divisible or duplicate
    mesh-axis assignments (first dim wins)."""
    used: set = set()
    entries = []
    for dim, ax in zip(shape, axes):
        mesh_ax = rules.get(ax) if ax is not None else None
        if mesh_ax is None:
            entries.append(None)
            continue
        axs = mesh_ax if isinstance(mesh_ax, tuple) else (mesh_ax,)
        if any(a in used for a in axs) or dim % _axis_size(mesh, mesh_ax) != 0:
            entries.append(None)
            continue
        used.update(axs)
        entries.append(mesh_ax)
    return P(*entries)


def param_pspecs(defs: Any, rules: Dict[str, Any], mesh: Any) -> Any:
    return tree_map(lambda d: spec_for(d.shape, d.axes, rules, mesh), defs)


def param_shardings(defs: Any, rules: Dict[str, Any], mesh: Any) -> Any:
    """Each param's DTensor placements on ``mesh`` (a ``DeviceMesh``)."""
    return to_shardings(param_pspecs(defs, rules, mesh), mesh)


# ---------------------------------------------------------------------------
# Batch / cache specs
# ---------------------------------------------------------------------------


def batch_pspecs(batch_specs: Dict[str, torch.Tensor], mesh: Any) -> Dict[str, P]:
    """The batch's leading dim over the dp axes where it divides."""
    dp, dpsz = dp_axes(mesh), dp_size(mesh)
    out = {}
    for k, v in batch_specs.items():
        b = v.shape[0] if v.dim() else 0
        lead = dp if (b and b % dpsz == 0) else None
        out[k] = P(lead, *([None] * (v.dim() - 1)))
    return out


def _auto_state_spec(shape: Sequence[int], mesh: Any, batch_dim: int = 0) -> P:
    """Heuristic for recurrent-state leaves: batch over dp, largest remaining
    dim over model."""
    dp, dpsz = dp_axes(mesh), dp_size(mesh)
    msz = mesh_shape(mesh).get("model", 1)
    entries: list = [None] * len(shape)
    if len(shape) > batch_dim and shape[batch_dim] % dpsz == 0:
        entries[batch_dim] = dp
    rest = [(d, i) for i, d in enumerate(shape) if i != batch_dim]
    for d, i in sorted(rest, reverse=True):
        if d % msz == 0 and msz > 1:
            entries[i] = "model"
            break
    return P(*entries)


def cache_pspecs(cfg, cache_spec: Any, mesh: Any) -> Any:
    """Specs for a decode cache tree (see ``decoding.init_cache``)."""
    dp, dpsz = dp_axes(mesh), dp_size(mesh)
    msz = mesh_shape(mesh).get("model", 1)

    def kv_spec(s):
        # (L, B, M, Hkv, Dh).  Prefer sharding kv heads over "model"; archs
        # with fewer kv heads than the model axis fall back to head_dim.
        # The attention kernels take neither an M nor a head_dim shard: the
        # model gathers the cache to the kernel's layout first
        # (``models/layers.py``).
        bt = dp if s.shape[1] % dpsz == 0 else None
        if getattr(cfg, "decode_seq_shard", False) and s.shape[2] % msz == 0:
            return P(None, bt, "model", None, None)  # flash-decode layout
        if s.shape[3] % msz == 0:
            return P(None, bt, None, "model", None)
        if s.shape[4] % msz == 0:
            return P(None, bt, None, None, "model")
        return P(None, bt, None, None, None)

    out: Dict[str, Any] = {}
    for key, val in cache_spec.items():
        if key in ("k", "v", "cross_k", "cross_v"):
            out[key] = kv_spec(val)
        elif key == "conv":  # (L,B,k-1,di)
            bt = dp if val.shape[1] % dpsz == 0 else None
            out[key] = P(None, bt, None, "model" if val.shape[3] % msz == 0 else None)
        elif key == "ssm":  # (L,B,di,n)
            bt = dp if val.shape[1] % dpsz == 0 else None
            out[key] = P(None, bt, "model" if val.shape[2] % msz == 0 else None, None)
        elif key == "pos":
            out[key] = P(None)
        elif key == "blocks":  # xlstm: list of per-layer state dicts
            out[key] = tree_map(lambda s: _auto_state_spec(s.shape, mesh), val)
        else:
            raise KeyError(key)
    return out


# ---------------------------------------------------------------------------
# Specs -> DTensor placements
# ---------------------------------------------------------------------------


def placements(spec: P, mesh: Any) -> Tuple[Placement, ...]:
    """``Shard(d)`` on every mesh dim named in entry ``d`` of ``spec``,
    ``Replicate()`` on the others.  A tuple entry shards its dim over several
    mesh dims, major to minor in mesh order, as JAX does; a tuple in another
    order has no DTensor placement and raises.  A mesh dim of size 1 is
    ``Replicate()`` whatever the spec says: its one rank holds the whole dim
    either way, and DTensor's view rules refuse to squeeze or merge a
    sharded dim even there (an MQA ``wk`` of 1 kv head, in an einsum)."""
    shape = mesh_shape(mesh)
    names = list(shape)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axs = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axs]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: entry {entry} is not in mesh order {names}")
        for i in idx:
            if shape[names[i]] > 1:
                out[i] = Shard(d)
    return tuple(out)


def to_shardings(pspec_tree: Any, mesh: Any) -> Any:
    """A tree of specs -> the same tree of placements."""
    return tree_map(lambda p: placements(p, mesh), pspec_tree)


def distribute(tree: Any, mesh, spec_tree: Any) -> Any:
    """Place every tensor of ``tree`` on ``mesh`` by the spec at its place in
    ``spec_tree``.  Every rank holds the whole tensor and keeps its own
    shard: nothing is sent."""
    from torch.distributed.tensor import distribute_tensor

    return tree_map(lambda t, p: distribute_tensor(t, mesh, placements(p, mesh),
                                                   src_data_rank=None), tree, spec_tree)


def check_placed(tree: Any, mesh, spec_tree: Any, what: str) -> None:
    """Raise unless every leaf of ``tree`` is a DTensor on ``mesh`` with the
    placements of its spec: a step never re-places its inputs quietly."""
    def check(t, p):
        want = placements(p, mesh)
        if not isinstance(t, DTensor) or t.device_mesh != mesh or tuple(t.placements) != want:
            got = (tuple(t.placements) if isinstance(t, DTensor) else type(t).__name__)
            raise ValueError(f"{what}: a leaf placed as {got}, not {want} ({p}) on the "
                             "step's mesh; place it with sharding.distribute")
    tree_map(check, tree, spec_tree)


def replicate_like(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t``, a tensor made on the local device, on ``like``'s side: a DTensor
    replicated on its mesh when ``like`` is one (DTensor refuses to mix with
    plain tensors), else ``t`` itself."""
    if isinstance(like, DTensor):
        mesh = like.device_mesh
        return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return t



def filled(shape: Sequence[int], value: float, dtype: torch.dtype, device, mesh,
           pl: Sequence[Placement]) -> DTensor:
    """A DTensor of ``shape`` filled with ``value`` on ``mesh``, placed by
    ``pl``, each rank making its own shard on ``device`` (DTensor's factories
    make it on the mesh's device type, which the dry-run's ``meta`` shards
    are not)."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    shape, pl = torch.Size(shape), tuple(pl)
    local, _ = compute_local_shape_and_global_offset(shape, mesh, pl)
    t = torch.full(local, value, dtype=dtype, device=device)
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))  # contiguous
    return DTensor.from_local(t, mesh, pl, run_check=False, shape=shape, stride=stride)


def zeros_beside(like: torch.Tensor, shape: Sequence[int], dim: int) -> torch.Tensor:
    """Zeros of ``shape`` in ``like``'s dtype, to concatenate to ``like``
    along ``dim``: a DTensor with ``like``'s placements (``dim`` unsharded)
    when ``like`` is one, each rank allocating its shard."""
    if not isinstance(like, DTensor):
        return torch.zeros(shape, dtype=like.dtype, device=like.device)
    pl = [Replicate() if p == Shard(dim) else p for p in like.placements]
    return filled(shape, 0, like.dtype, like.device, like.device_mesh, pl)


def relayout(t: DTensor, pl: Sequence[Placement]) -> DTensor:
    """``t`` re-placed to ``pl`` (itself when it is placed so already).  The
    bytes by which its local tensor grows, what this rank receives in an
    all-gather, are added to ``relayout.gathered_bytes``; the local bytes of
    a ``Partial`` tensor, what this rank sends into an all-reduce or a
    reduce-scatter, to ``relayout.reduced_bytes``."""
    pl = tuple(pl)
    if tuple(t.placements) == pl:
        return t
    before = t.to_local().numel()
    if any(p.is_partial() for p in t.placements):
        relayout.reduced_bytes += before * t.element_size()
    out = t.redistribute(t.device_mesh, pl)
    relayout.gathered_bytes += max(out.to_local().numel() - before, 0) * t.element_size()
    return out


relayout.gathered_bytes = 0
relayout.reduced_bytes = 0


def local_call(fn: Callable, in_pl: Sequence[Any], out_pl: Any, *args: DTensor,
               grad_pl: Optional[Sequence[Any]] = None) -> Any:
    """``fn`` on each rank's local tensors of ``args``, each first re-placed
    to its entry of ``in_pl`` (``relayout``); the outputs become DTensors
    placed by ``out_pl`` (one placement tuple, or a tuple of them for a tuple
    of outputs).  A kernel wrapper is called so: it sees plain tensors only.
    ``grad_pl`` gives the placements of each argument's local grad where
    they differ from ``in_pl`` (a ``Partial`` where each rank's grad is its
    share of the sum); the default is ``in_pl``."""
    from torch.distributed.tensor.experimental import local_map

    mesh = args[0].device_mesh
    args = tuple(relayout(a, pl) for a, pl in zip(args, in_pl))
    # local_map reads a tuple as one placement list per output, a list as one
    one = all(isinstance(p, Placement) for p in out_pl)
    out = list(out_pl) if one else tuple(list(p) for p in out_pl)
    grads = None if grad_pl is None else tuple(list(p) for p in grad_pl)
    return local_map(fn, out_placements=out, in_placements=tuple(list(p) for p in in_pl),
                     in_grad_placements=grads, device_mesh=mesh)(*args)


class _PinGrad(torch.autograd.Function):
    """The identity; the backward re-places the grad to the forward's
    placements where it shards dim ``dim`` over a mesh dim whose size does
    not divide ``heads``."""

    @staticmethod
    def forward(ctx, t, dim, heads):
        ctx.pl, ctx.dim, ctx.heads = tuple(t.placements), dim, heads
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        if any(p == Shard(ctx.dim) and ctx.heads % g.device_mesh.size(i)
               for i, p in enumerate(g.placements)):
            g = relayout(g, [Replicate() if p.is_partial() else p for p in ctx.pl])
        return g, None, None


def pin_grad(t: torch.Tensor, dim: int, heads: int) -> torch.Tensor:
    """``t``, whose grad reaches a backward that splits or merges its dim
    ``dim`` of ``heads`` heads (a reshape), re-placed in the backward to
    ``t``'s forward placements where the grad shards ``dim`` over a mesh dim
    whose size does not divide ``heads``: DTensor has no placement for that
    split or merge, and raises.  Elsewhere the grad is left as it comes, so
    that a backward that runs as it is pays nothing.  ``t`` itself for a
    plain tensor, one with no grad, or one head (MQA: DTensor moves the
    shard to the other dim of the split)."""
    if heads == 1 or not isinstance(t, DTensor) or not t.requires_grad:
        return t
    return _PinGrad.apply(t, dim, heads)


def batch_einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, *ops)``, every operand and the result batch-first.
    Where grads flow on a mesh and the batch does not divide the whole mesh,
    it runs in a ``local_call`` island on each rank's batch rows (over the dp
    axes where they divide, every other dim whole): the backward of
    DTensor's einsum shards the product's merged (batch, heads) dim over
    every rank, which the split back to (batch, heads) cannot undo then
    (2 x 16 x 16's (32, 16) view, 256 rows over 512 ranks)."""
    t = ops[0]
    if not (isinstance(t, DTensor) and torch.is_grad_enabled()
            and any(o.requires_grad for o in ops) and t.shape[0] % t.device_mesh.size()):
        return torch.einsum(eq, *ops)
    mesh = t.device_mesh
    bt = "dp" if t.shape[0] % dp_size(mesh) == 0 else None
    out_dims = len(eq.split("->")[1])
    pl = [kernel_layout(mesh, (bt,) + (None,) * (o.dim() - 1)) for o in ops]
    return local_call(lambda *xs: torch.einsum(eq, *xs), pl,
                      kernel_layout(mesh, (bt,) + (None,) * (out_dims - 1)), *ops)


def kernel_layout(mesh: Any, spec: Sequence[Any]) -> Tuple[Placement, ...]:
    """Placements of a kernel operand: ``spec``'s entries, with "dp" standing
    for the mesh's data-parallel axes."""
    return placements(P(*(dp_axes(mesh) if e == "dp" else e for e in spec)), mesh)
