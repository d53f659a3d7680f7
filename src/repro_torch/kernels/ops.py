"""Model-layout wrappers around the kernels, with launch counters.

Port of ``repro.kernels.ops``.  Layout contract with ``repro_torch.models``:
attention activations are (B, S, H, D), caches are (B, M, Hkv, D); the scans
take the mixer's (B, S, di[, N]) tensors in f32.

Dispatch is by the device of the tensors and nothing else: a CPU tensor goes
to the plain version in ``ref``; a CUDA tensor launches the CUDA kernel or
raises; a ``meta`` tensor (the dry-run, ``launch/dryrun.py``) gets empty
outputs of the kernel's shapes and dtypes, and nothing runs.  The arguments
are checked once per call: by the launcher on the card, by the same
``check_args`` here on the CPU and on ``meta``.  Each wrapper's
``launches`` attribute counts the calls that launched its kernel (the plain
version and ``meta`` calls are not counted); one K2 call runs two grids,
split and combine.

A call that launched its kernel or ran on ``meta`` is charged to every
function in ``COST_OBSERVERS`` (the step counter of ``launch/analysis.py``)
as ``(name, flops, nbytes)`` from its shapes alone (``kernel_cost``), the
same on both, so a dry-run's count equals the card's.  The CPU's plain
versions are plain PyTorch, which a counter sees op by op.

The scans take any S: the kernels need no chunk multiple, so there is no
padding here (the JAX wrappers pad with identity steps, which leave y and
h_last as they are).

No kernel has a backward, here or in the JAX package (which cannot
differentiate its Pallas calls either).  A kernel's output is a fresh tensor
with no ``grad_fn``, so a backward pass through it would leave everything
upstream without a gradient, silently.  So each wrapper refuses, on every
device, a call under grad mode with an input that requires grad.  Training
runs ``attention_impl="xla"``, which reaches no kernel on any family: the
hybrid block's scans train through the reference's differentiable scans in
the model code (``models/ssm.py``), and K3 and K4 serve its prefill alone.

Each wrapper refuses a ``DTensor`` with a ``TypeError``: a launch reads
``data_ptr()``, which a DTensor does not hold as its local shard.  On a mesh
the model calls the wrappers on each rank's local tensors, inside
``local_map`` (``repro_torch.sharding.local_call``).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.decode_attention import check_args as _check_decode
from repro_torch.kernels.decode_attention import decode_attention_bmhd
from repro_torch.kernels.flash_attention import check_args as _check_flash
from repro_torch.kernels.flash_attention import flash_attention_bshd
from repro_torch.kernels.ssm_scan import check_fused_args as _check_fused
from repro_torch.kernels.ssm_scan import check_scan_args as _check_scan
from repro_torch.kernels.ssm_scan import ssm_scan_bsdn, ssm_scan_fused_bsd


# called as fn(name, flops, nbytes) for each kernel call on CUDA or meta
COST_OBSERVERS: List[Callable[[str, float, float], None]] = []


def kernel_cost(name: str, *args: torch.Tensor) -> Tuple[float, float]:
    """(FLOPs, bytes) of one call of kernel ``name`` on the wrapper's
    arguments, from their shapes: each input read once and each output
    written once; FLOPs of the products (K1 over the causal pairs).  K2 is
    charged for its whole cache, M slots: the valid lengths are values on
    the device, which a count from shapes cannot read.  These are the
    formulas of the bound column of PERF.md's kernel table (K3's exps
    aside, which are not FLOPs)."""
    if name == "flash_attention":
        q, k = args[:2]
        b, s, hq, d = q.shape
        return (2.0 * b * hq * d * s * (s + 1),
                float(q.element_size() * (2 * b * s * hq * d + 2 * b * s * k.shape[2] * d)))
    if name == "decode_attention":
        q, cache_k = args[:2]
        b, _, hq, d = q.shape
        m, hkv = cache_k.shape[1], cache_k.shape[2]
        return (4.0 * b * hq * m * d,
                float(q.element_size() * (2 * b * hq * d + 2 * b * m * hkv * d) + 4 * b))
    if name == "ssm_scan":
        b, s, di, n = args[0].shape
        return 4.0 * b * s * di * n, float(4 * (2 * b * s * di * n + b * s * n + b * s * di
                                                + b * di * n))
    if name == "ssm_scan_fused":
        b, s, di = args[0].shape
        n = args[4].shape[1]
        return 7.0 * b * s * di * n, float(4 * (2 * b * s * di + 2 * b * s * n + di * n
                                                + b * s * di + b * di * n))
    raise KeyError(name)


def _charge(name: str, *args: torch.Tensor) -> None:
    if COST_OBSERVERS:
        flops, nbytes = kernel_cost(name, *args)
        for fn in COST_OBSERVERS:
            fn(name, flops, nbytes)


def no_backward_message(name: str) -> str:
    return (f"{name}: the kernel has no backward, in the port or in the JAX package, "
            "so a gradient cannot flow through it; training uses attention_impl='xla', "
            "which calls no kernel")


def _refuse(name: str, *tensors: torch.Tensor) -> None:
    """Refuse a DTensor argument, and a call that autograd would record."""
    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError(f"{name}: a DTensor argument; call the wrapper on the local "
                        "tensors (repro_torch.sharding.local_call), never on a DTensor")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(no_backward_message(name))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal GQA attention.  q: (B,S,Hq,D); k,v: (B,S,Hkv,D) -> (B,S,Hq,D)."""
    _refuse("flash_attention", q, k, v)
    if q.device.type == "cpu":
        _check_flash(q, k, v)
        out = _ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                       v.transpose(1, 2))
        return out.transpose(1, 2)
    if q.device.type == "meta":
        _check_flash(q, k, v)
        out = torch.empty_like(q, memory_format=torch.contiguous_format)
    else:
        out = flash_attention_bshd(q, k, v)
        flash_attention.launches += 1
    _charge("flash_attention", q, k, v)
    return out


def decode_attention(q: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """q: (B,1,Hq,D); cache_{k,v}: (B,M,Hkv,D); lengths (B,) int32 ->
    (B,1,Hq,D).  Cache slots at or past ``lengths`` are masked."""
    _refuse("decode_attention", q, cache_k, cache_v, lengths)
    if q.device.type == "cpu":
        _check_decode(q, cache_k, cache_v, lengths)
        out = _ref.decode_attention_ref(q[:, 0], cache_k.transpose(1, 2),
                                        cache_v.transpose(1, 2), lengths)
        return out[:, None]
    if q.device.type == "meta":
        _check_decode(q, cache_k, cache_v, lengths)
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    else:
        out = decode_attention_bmhd(q, cache_k, cache_v, lengths)
        decode_attention.launches += 1
    _charge("decode_attention", q, cache_k, cache_v, lengths)
    return out


def ssm_scan(dA: torch.Tensor, dBx: torch.Tensor, C: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: h_t = dA_t * h_{t-1} + dBx_t, y_t = <h_t, C_t>.  dA, dBx:
    (B,S,di,N) f32; C: (B,S,N) f32 -> (y (B,S,di), h_last (B,di,N)) f32."""
    _refuse("ssm_scan", dA, dBx, C)
    if dA.device.type == "cpu":
        _check_scan(dA, dBx, C)
        return _ref.ssm_scan_ref(dA, dBx, C)
    if dA.device.type == "meta":
        _check_scan(dA, dBx, C)
        out = _meta_scan_outputs(*dA.shape)
    else:
        out = ssm_scan_bsdn(dA, dBx, C)
        ssm_scan.launches += 1
    _charge("ssm_scan", dA, dBx, C)
    return out


def ssm_scan_fused(delta: torch.Tensor, B: torch.Tensor, C: torch.Tensor, x: torch.Tensor,
                   A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: the scan with its discretisation (dA = exp(delta A), dBx = delta B
    x) fused in.  delta, x: (B,S,di); B, C: (B,S,N); A: (di,N); f32 ->
    (y (B,S,di), h_last (B,di,N)) f32."""
    _refuse("ssm_scan_fused", delta, B, C, x, A)
    if delta.device.type == "cpu":
        _check_fused(delta, B, C, x, A)
        return _ref.ssm_scan_ref(*_ref.ssm_discretize(delta, B, x, A), C)
    if delta.device.type == "meta":
        _check_fused(delta, B, C, x, A)
        out = _meta_scan_outputs(*delta.shape, A.shape[1])
    else:
        out = ssm_scan_fused_bsd(delta, B, C, x, A)
        ssm_scan_fused.launches += 1
    _charge("ssm_scan_fused", delta, B, C, x, A)
    return out


def _meta_scan_outputs(b: int, s: int, di: int, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Empty (y (B,S,di), h_last (B,di,N)) f32 on ``meta``: what K3 and K4 return."""
    return (torch.empty((b, s, di), dtype=torch.float32, device="meta"),
            torch.empty((b, di, n), dtype=torch.float32, device="meta"))


flash_attention.launches = 0
decode_attention.launches = 0
ssm_scan.launches = 0
ssm_scan_fused.launches = 0
KERNELS = {"flash_attention": flash_attention, "decode_attention": decode_attention,
           "ssm_scan": ssm_scan, "ssm_scan_fused": ssm_scan_fused}
# __global__ kernels one wrapper call launches
GRIDS_PER_CALL = {"flash_attention": 1, "decode_attention": 2, "ssm_scan": 1,
                  "ssm_scan_fused": 1}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launches() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}
