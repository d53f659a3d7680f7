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
``meta``, so the card's count of a step equals its dry-run's.  Collectives
have no counterpart on one device: ``no_collectives`` keeps the record's
keys at zero until the dry-run runs on a mesh (ROADMAP.md Queue 1 item
5a-iv).

Hardware model: one H100 SXM (``launch/mesh.py::HW``).
"""
from __future__ import annotations

import functools
import weakref
from typing import Any, Dict

import torch
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


class StepCost(TorchDispatchMode):
    """Counts the FLOPs, bytes and peak live bytes of what runs while it is
    open (module docstring).  ``inputs``: the step's arguments, whose
    storages are live from the start; ``device``: the step's device (storages
    elsewhere, such as a CPU scalar, are not counted)."""

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
        self._storages: Dict[int, list] = {}  # key -> [nbytes, weakref]
        for t in tree_leaves(inputs):
            self._track(t)
        self.input_bytes = self.live

    @property
    def flops(self) -> float:
        return float(self.op_flops) + self.kernel_flops

    @property
    def total_bytes(self) -> float:
        return float(self.nbytes) + self.kernel_bytes

    def _track(self, t) -> None:
        if not isinstance(t, torch.Tensor) or t.device.type != self.device_type:
            return
        st = t.untyped_storage()
        key, n = st._cdata, st.nbytes()
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

    def __enter__(self):
        kops.COST_OBSERVERS.append(self._kernel)
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        kops.COST_OBSERVERS.remove(self._kernel)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
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
    """The reference's collective statistics, all zero: one device runs no
    collective (a mesh's: ROADMAP.md Queue 1 item 5a-iv)."""
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
