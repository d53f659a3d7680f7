"""Parameter definitions: one source of truth for shape, logical axes, init.

Port of ``repro.models.params``.  A model is a nested dict (or list) of
``ParamDef``s; ``init_params`` turns it into tensors with the same keys.
``abstract_params`` gives the same tree as ``meta`` tensors (the dry-run's
stand-ins: shapes and dtypes, no storage).  ``params_from_numpy`` carries a
parameter tree made elsewhere (for example
the JAX package's, converted leaf by leaf to numpy) into the same structure.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]  # logical axis name per dim (None = replicated)
    init: str = "normal"  # normal | zeros | ones | embed | scaled
    scale: float = 1.0  # stddev multiplier / fan-in override
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self) -> None:
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes} rank mismatch")


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """Map ``fn`` over the leaves of nested dicts / lists / tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree: Any) -> List[Any]:
    """Leaves in a fixed order: dict keys sorted, as ``jax.tree_util`` does."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in ``tree_leaves`` order, each path formatted as
    ``jax.tree_util.keystr`` formats it: ``['blocks']['attn']['wq']``, and
    ``[0]`` for a list item."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in tree_paths(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree) for pl in tree_paths(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def tree_unflatten(like: Any, leaves: List[Any]) -> Any:
    """``leaves``, in ``tree_leaves`` order, in the structure of ``like``."""
    if len(leaves) != len(tree_leaves(like)):
        raise ValueError(f"{len(leaves)} leaves for a tree of {len(tree_leaves(like))}")
    it = iter(leaves)

    def build(t: Any) -> Any:
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(like)


def _init_leaf(d: ParamDef, generator: torch.Generator, device) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=d.dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=d.dtype, device=device)
    x = torch.empty(d.shape, dtype=torch.float32, device=device)
    if d.init in ("normal", "embed"):
        # truncated normal at +-2 sigma, drawn in f32 and cast, as the JAX
        # package does.  trunc_normal_ takes ABSOLUTE bounds a, b.
        if d.init == "normal":
            # fan_in = second-to-last dim (the last two dims are the matmul dims)
            fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
            std = d.scale / math.sqrt(max(fan_in, 1))
        else:
            std = d.scale
        torch.nn.init.trunc_normal_(x, mean=0.0, std=std, a=-2.0 * std, b=2.0 * std,
                                    generator=generator)
    elif d.init == "scaled":  # uniform in +-scale (conv/ssm misc params)
        x.uniform_(-d.scale, d.scale, generator=generator)
    else:
        raise ValueError(f"unknown init {d.init!r}")
    return x.to(d.dtype)


def init_params(defs: Any, generator: torch.Generator, device=None) -> Any:
    """Initialise every ParamDef of ``defs``; the generator must live on
    ``device`` (default: the generator's own device)."""
    device = generator.device if device is None else torch.device(device)
    return tree_map(lambda d: _init_leaf(d, generator, device), defs)


def abstract_params(defs: Any) -> Any:
    """Every ParamDef of ``defs`` as an empty ``meta`` tensor of its shape and
    dtype: nothing is allocated or drawn."""
    return tree_map(lambda d: torch.empty(d.shape, dtype=d.dtype, device="meta"), defs)


def count_params(defs: Any) -> int:
    return int(sum(math.prod(d.shape) for d in tree_leaves(defs)))


def param_bytes(defs: Any) -> int:
    return int(sum(math.prod(d.shape) * d.dtype.itemsize for d in tree_leaves(defs)))


def _tensor_from_numpy(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if not a.flags.writeable:  # e.g. a view of a JAX array's buffer
        a = a.copy()
    if a.dtype.name == "bfloat16":
        # ml_dtypes.bfloat16 has no torch counterpart in numpy: carry the raw
        # bits (uint16) and reinterpret, never round-tripping through f32
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device)


def params_from_numpy(tree: Any, device="cuda", mesh=None, specs: Any = None) -> Any:
    """Nested dicts/lists of numpy arrays -> the same structure of tensors,
    same keys, shapes and dtypes (stacked leading L dims stay).  With a
    ``mesh`` (a ``DeviceMesh``) each tensor is then placed by its spec in
    ``specs`` (``sharding.param_pspecs``): a rank holds its shard of the same
    values."""
    device = torch.device(device)
    out = tree_map(lambda a: _tensor_from_numpy(a, device), tree)
    if mesh is None:
        return out
    from repro_torch.sharding import distribute

    return distribute(out, mesh, specs)
