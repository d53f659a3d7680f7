"""Roofline terms of one step, from an eager count of its work (port of
``repro.launch.analysis``).

The reference reads XLA's compiled module: ``cost_analysis()`` for FLOPs and
bytes, ``memory_analysis()`` for the peak, and the HLO text for collective
bytes.  Eager PyTorch has no compiled module, so ``StepCost`` counts the
step as it runs, op by op, on ``meta`` tensors (the dry-run: shapes only,
nothing allocated) or on the card:

- **FLOPs**: the matmul-class ops that ``torch.utils.flop_counter`` counts
  (mm, bmm, addmm, baddbmm, convolutions, the fused attentions; its
  ``flop_registry``, as ``FlopCounterMode`` applies it), forward and
  backward, plus each kernel call's FLOPs from its shapes
  (``kernels.ops.kernel_cost``).  Elementwise ops (norms, softmax,
  activations, the optimizer) are left out, where XLA's count has them: so
  these FLOPs are not the reference's ``hlo_flops_per_dev``.
- **Bytes**: what each aten op reads and writes, every tensor argument read
  once and every output written once (a gather reads only what it gathers;
  views and allocations move nothing), plus each kernel call's bytes.  That
  is the eager, unfused traffic the port really moves.
- **Peak live bytes**: the storages on the step's device, counted as they
  are created and freed (views share their storage), the step's inputs
  (params, optimizer state, batch, cache) included.  Tensors autograd
  saves and moments updated in place are storages like any other.

A kernel call is charged the same work whether it launched or ran on
``meta``, so the card's count of a step equals its dry-run's.

On a mesh (DTensor steps) it counts what one device does.  An op between
DTensors is handed back to DTensor (``__torch_dispatch__`` returns
``NotImplemented`` when a tensor subclass is among its types, as
``torch.distributed.tensor.debug.CommDebugMode`` does), which runs it as
local ops and ``_c10d_functional`` collectives on plain tensors, and those
come back to the counter: FLOPs, bytes and storages are the local
tensors'.  The collectives, implicit ones included, are classified with
the reference's conventions (``collective_kind``, ``collective_bytes``,
``repro.launch.analysis.collective_stats``) into ``collectives()``; their
bytes go to the collective terms and not to ``total_bytes``.  One device
runs none: ``no_collectives`` is its record.  DTensor's sharding
propagation runs example ops at global shapes that no device runs: the
counter sets them aside while it runs.  The wrapper funcol puts around a
collective's result holds no storage of its own, though ``meta``'s kernel
for it makes a copy (``StepCost._alias``).  So a fake rank's count of a
step on ``meta`` equals a real rank's, exactly
(``tests/test_torch_mesh_dryrun.py``).

Hardware model: one H100 SXM (``launch/mesh.py::HW``).
"""
from __future__ import annotations

import functools
import weakref
from typing import Any, Dict

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import ops as kops
from repro_torch.launch.mesh import HW

aten = torch.ops.aten
# allocations: they write nothing
_NO_TRAFFIC = {aten.empty.memory_format, aten.empty_strided.default, aten.empty_like.default,
               aten.new_empty.default, aten.new_empty_strided.default}
# reads only the rows it gathers (the output's worth) and the indices
_GATHERS = {aten.embedding.default, aten.index.Tensor, aten.index_select.default,
            aten.gather.default}
# writes only the values it scatters, read with the indices
_PUTS = {aten.index_put.default, aten.index_put_.default, aten._index_put_impl_.default}


# the reference's HLO op names for the _c10d_functional collectives
_COLLECTIVE_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_out": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all",
    "isend": "collective-permute", "irecv": "collective-permute",
    "batch_p2p_ops": "collective-permute",
    "wait_tensor": None, "_wrap_tensor_autograd": None,  # move nothing
}
# DTensor's sharding propagator's entry points
_PROPAGATORS = ("propagate_op_sharding", "propagate_op_sharding_non_cached")
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd", "_dtensor")


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if isinstance(t, torch.Tensor))


@functools.lru_cache(maxsize=None)
def _kind(func) -> str:
    """How an op moves bytes: "view" (an alias: nothing, and no storage),
    "alloc" (allocates, writes nothing), "gather", "put" or "op"."""
    if any(r.alias_info is not None and not r.alias_info.is_write
           for r in func._schema.returns):
        return "view"
    if func in _NO_TRAFFIC:
        return "alloc"
    return "gather" if func in _GATHERS else "put" if func in _PUTS else "op"


def op_bytes(func, args, kwargs, out) -> int:
    """Bytes one aten op reads and writes (see the module docstring)."""
    kind = _kind(func)
    if kind in ("view", "alloc"):
        return 0
    outs = tree_leaves(out)
    if kind == "gather":
        return 2 * _nbytes(outs) + _nbytes(tree_leaves((args[1:], kwargs)))
    if kind == "put":
        values = args[2] if len(args) > 2 else kwargs["values"]
        return _nbytes(tree_leaves((args[1:], kwargs))) + _nbytes([values])
    return _nbytes(tree_leaves((args, kwargs))) + _nbytes(outs)


def collective_kind(func) -> Any:
    """The reference's name for the collective that ``func`` runs
    ("all-reduce", "all-gather", "reduce-scatter", "all-to-all" or
    "collective-permute"); None for a ``_c10d_functional`` op that moves
    nothing (``wait_tensor``); False for any other op.  An unknown
    ``_c10d_functional`` op raises: no collective goes uncounted."""
    ns, _, name = func._schema.name.partition("::")
    if ns not in _COLLECTIVE_NAMESPACES:
        return False
    if name not in _COLLECTIVE_KINDS:
        raise NotImplementedError(f"StepCost cannot classify the collective {func}")
    return _COLLECTIVE_KINDS[name]


def collective_bytes(kind: str, result_bytes: int, group_size: int):
    """(operand, wire) bytes of one collective of ``kind`` whose result on
    this device is ``result_bytes``, over a group of ``group_size``, as
    ``repro.launch.analysis.collective_stats`` counts them: all-reduce
    operand = result, wire 2(g-1)/g of it; all-gather operand = result/g,
    wire (g-1)/g of the result; reduce-scatter operand = result·g, wire
    (g-1)·result; all-to-all operand = result, wire (g-1)/g of it;
    permute operand = wire = result."""
    g, res = max(group_size, 1), result_bytes
    if kind == "all-reduce":
        return res, int(2 * (g - 1) / g * res)
    if kind == "all-gather":
        return res // g, int((g - 1) / g * res)
    if kind == "reduce-scatter":
        return res * g, (g - 1) * res
    if kind == "all-to-all":
        return res, int((g - 1) / g * res)
    return res, res


def _group_size(func, args, kwargs) -> int:
    """The size of the group a ``_c10d_functional`` op runs over, from its
    ``group_name`` argument (a name, or the group itself)."""
    from torch.distributed import distributed_c10d

    names = [a.name for a in func._schema.arguments]
    group = kwargs["group_name"] if "group_name" in kwargs else args[names.index("group_name")]
    if isinstance(group, str):
        group = distributed_c10d._resolve_process_group(group)
    return group.size()


class StepCost(TorchDispatchMode):
    """Counts the FLOPs, bytes, peak live bytes and collectives of what runs
    on one device while it is open (module docstring).  ``inputs``: the
    step's arguments (plain tensors or DTensors, whose local tensors are
    counted), whose storages are live from the start; ``device``: the step's
    device (storages elsewhere, such as a CPU scalar, are not counted).
    ``total_bytes`` holds no collective's bytes: they are in
    ``collectives()``."""

    def __init__(self, inputs: Any = (), device="meta"):
        super().__init__()
        self.device_type = torch.device(device).type
        self.op_flops = 0
        self.nbytes = 0
        self.kernel_flops = 0.0
        self.kernel_bytes = 0.0
        self.kernel_calls: Dict[str, int] = {}
        self.live = 0
        self.peak = 0
        self.coll_counts: Dict[str, int] = {}
        self.coll_operand: Dict[str, int] = {}
        self.coll_wire: Dict[str, int] = {}
        self._storages: Dict[int, list] = {}  # key -> [nbytes, weakref]
        self._aliases: Dict[int, Any] = {}  # key -> weakref (see _alias)
        self._propagating = 0
        for t in tree_leaves(inputs):
            self._track(t)
        self.input_bytes = self.live

    @property
    def flops(self) -> float:
        return float(self.op_flops) + self.kernel_flops

    @property
    def total_bytes(self) -> float:
        return float(self.nbytes) + self.kernel_bytes

    def collectives(self) -> Dict[str, Any]:
        """The reference's collective statistics of what was counted: counts,
        operand and wire bytes by kind, and their totals."""
        return {"counts": dict(self.coll_counts), "operand_bytes": dict(self.coll_operand),
                "wire_bytes": dict(self.coll_wire),
                "total_operand": sum(self.coll_operand.values()),
                "total_wire": sum(self.coll_wire.values())}

    def _collective(self, kind: str, nbytes: int, group_size: int) -> None:
        operand, wire = collective_bytes(kind, nbytes, group_size)
        self.coll_counts[kind] = self.coll_counts.get(kind, 0) + 1
        self.coll_operand[kind] = self.coll_operand.get(kind, 0) + operand
        self.coll_wire[kind] = self.coll_wire.get(kind, 0) + wire

    def _alias(self, t, of) -> None:
        """``t`` wraps ``of`` (funcol's wrapper of a collective's result): no
        storage of its own.  Where a kernel made it a copy (``meta``'s), its
        storage is never counted and ``of`` lives as long as it does."""
        if type(t) is not torch.Tensor or t.device.type != self.device_type:
            return  # the wrapper itself: it holds ``of``
        st = t.untyped_storage()
        if st._cdata != of.untyped_storage()._cdata:
            key = st._cdata
            self._aliases[key] = weakref.ref(st, lambda _r: self._aliases.pop(key, None))
            t._wraps = of

    def _track(self, t) -> None:
        if isinstance(t, DTensor):
            t = t._local_tensor
        if not isinstance(t, torch.Tensor) or t.device.type != self.device_type:
            return
        st = t.untyped_storage()
        key, n = st._cdata, st.nbytes()
        if key in self._aliases:
            return
        entry = self._storages.get(key)
        if entry is None:
            self._storages[key] = [n, weakref.ref(st, functools.partial(self._freed, key))]
            self.live += n
        elif entry[0] != n:  # resized in place
            self.live += n - entry[0]
            entry[0] = n
        self.peak = max(self.peak, self.live)

    def _freed(self, key: int, _ref) -> None:
        entry = self._storages.pop(key, None)
        if entry is not None:
            self.live -= entry[0]

    def _kernel(self, name: str, flops: float, nbytes: float) -> None:
        self.kernel_flops += flops
        self.kernel_bytes += nbytes
        self.kernel_calls[name] = self.kernel_calls.get(name, 0) + 1

    def _set_aside(self, fn):
        """``fn`` with what it runs set aside by the count."""
        @functools.wraps(fn)
        def call(*args, **kwargs):
            self._propagating += 1
            try:
                return fn(*args, **kwargs)
            finally:
                self._propagating -= 1
        return call

    def __enter__(self):
        kops.COST_OBSERVERS.append(self._kernel)
        # DTensor's sharding propagation runs example ops at global shapes (on
        # fake or meta tensors) that no device runs: set them aside
        prop = DTensor._op_dispatcher.sharding_propagator
        self._patched = [(name, prop.__dict__.get(name)) for name in _PROPAGATORS
                         if hasattr(prop, name)]
        for name, _ in self._patched:
            setattr(prop, name, self._set_aside(getattr(prop, name)))
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        prop = DTensor._op_dispatcher.sharding_propagator
        for name, old in self._patched:
            if old is None:
                delattr(prop, name)
            else:
                setattr(prop, name, old)
        kops.COST_OBSERVERS.remove(self._kernel)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._propagating:  # DTensor's sharding propagation: no device runs it
            return func(*args, **kwargs)
        if any(t is not torch.Tensor for t in types):
            # a DTensor (or funcol's wrapper): it runs the op as local ops and
            # collectives on plain tensors, which come back here
            return NotImplemented
        out = func(*args, **kwargs)
        coll = collective_kind(func)
        if coll is not False:  # a collective: its bytes are collective terms
            if coll is not None:
                self._collective(coll, _nbytes(tree_leaves(out)),
                                 _group_size(func, args, kwargs))
            if func._schema.name.endswith("::_wrap_tensor_autograd"):
                self._alias(out, args[0])
                return out
            for t in tree_leaves(out):
                self._track(t)
            return out
        if _kind(func) == "view":  # shares a storage already counted
            return out
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.op_flops += count(*args, **kwargs, out_val=out)
        self.nbytes += op_bytes(func, args, kwargs, out)
        for t in tree_leaves(out):
            self._track(t)
        return out


def no_collectives() -> Dict[str, Any]:
    """The reference's collective statistics, all zero: the record of a step
    on one device (``mesh=None``), which runs no collective; on a mesh they
    are ``StepCost.collectives()``."""
    return {"counts": {}, "operand_bytes": {}, "wire_bytes": {}, "total_operand": 0,
            "total_wire": 0}


def roofline_terms(flops: float, nbytes: float, coll: Dict[str, Any]) -> Dict[str, Any]:
    """The roofline terms in seconds (per step, per card) and the dominant
    one, against the H100's peaks (``HW``); the collective terms over one
    NVLink direction."""
    t_compute = flops / HW["peak_flops_bf16"]
    t_memory = nbytes / HW["hbm_bw"]
    t_coll = coll["total_operand"] / HW["nvlink_bw"]
    terms: Dict[str, Any] = {"compute_s": t_compute, "memory_s": t_memory,
                             "collective_s": t_coll,
                             "collective_wire_s": coll["total_wire"] / HW["nvlink_bw"]}
    terms["dominant"] = max(("compute_s", "memory_s", "collective_s"), key=lambda k: terms[k])
    bound = max(t_compute, t_memory, t_coll)
    terms["bound_s"] = bound
    terms["roofline_fraction"] = t_compute / bound if bound > 0 else 0.0
    return terms


def model_flops(cfg, shape) -> float:
    """Analytic MODEL_FLOPS: 6·N·D train, 2·N·D inference (N = active
    params, D = tokens processed globally this step)."""
    n = cfg.n_active_params()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        if cfg.family == "vlm":
            tokens += shape.global_batch * cfg.n_img_tokens \
                - shape.global_batch * cfg.n_img_tokens  # text-only targets
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token per sequence
