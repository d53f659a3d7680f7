"""Int8 gradient compression with error feedback (port of
``repro.optim.compression``): a mean over data-parallel ranks whose wire
format is one byte an element.

- grads are quantized to int8 with one shared per-tensor scale;
- they are exchanged at int8 width: a reduce-scatter and an all-gather
  built from ``all_to_all_single`` and ``all_gather`` of int8 tensors (an
  all-reduce would sum, and so travel, at the grads' own width);
- the quantization residual is kept in an error-feedback buffer that is
  added to the next step's grad.

The reference's ``axis_name``, named inside ``shard_map``, is here the
process group of that axis (``mesh.get_group("data")``; None for the
default group), and the tensors are each rank's own, as inside
``shard_map``.  Nothing wires this into a train step, as in the reference.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import sharding as SH


def quantize_int8(x: torch.Tensor, scale: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: (q, scale), q = round(x / scale) (half to
    even, as ``jnp.round``) clipped to +-127, scale = max|x| / 127."""
    xf = x.float()
    if scale is None:
        scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_with_feedback(grad: torch.Tensor, error: torch.Tensor,
                           scale: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(grad + carried error) -> (q, scale, new_error)."""
    corrected = grad.float() + error
    q, scale = quantize_int8(corrected, scale)
    return q, scale, corrected - dequantize_int8(q, scale)


def compressed_mean(x: torch.Tensor, error: torch.Tensor, group=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The mean of each rank's ``x`` over ``group``, exchanged at int8:
    (mean f32, this rank's new error).

    The shared scale is an all-reduce MAX of |x + error|; each rank's
    quantized, zero-padded flat tensor is reduce-scattered at int8 (an
    ``all_to_all_single``: rank j receives everyone's j-th slice), summed
    in f32, re-quantized with the slice's own scale, and all-gathered at
    int8 with the f32 scales beside it.  The result is cut back to x's
    size."""
    n = dist.get_world_size(group)
    numel = x.numel()
    pad = (-numel) % n
    flat = torch.cat([x.reshape(-1), x.new_zeros(pad)])
    err_flat = torch.cat([error.reshape(-1), error.new_zeros(pad)])
    corrected = flat.float() + err_flat
    # shared scale, so that the ranks' int8 values sum coherently
    amax = corrected.abs().max()
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(corrected / scale), -127, 127).to(torch.int8)
    new_error = corrected - q.float() * scale
    # reduce-scatter at int8: each rank receives its 1/n slice of every q
    recv = torch.empty_like(q)
    dist.all_to_all_single(recv, q, group=group)
    local_sum = torch.sum(recv.reshape(n, -1).float(), dim=0) * scale / n
    # all-gather the reduced slice at int8, re-quantized with its own scale
    q2, scale2 = quantize_int8(local_sum)
    gathered = [torch.empty_like(q2) for _ in range(n)]
    dist.all_gather(gathered, q2, group=group)
    scales = [torch.empty_like(scale2.reshape(1)) for _ in range(n)]
    dist.all_gather(scales, scale2.reshape(1), group=group)
    mean = (torch.stack(gathered).float() * torch.cat(scales)[:, None]).reshape(-1)
    return mean[:numel].reshape(x.shape), new_error[:numel].reshape(x.shape)


def init_error_tree(params: Any) -> Any:
    return SH.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                       params)


def compressed_mean_tree(grads: Any, errors: Any, group=None) -> Tuple[Any, Any]:
    """``compressed_mean`` of every leaf of ``grads`` with its error: (the
    tree of means, the tree of new errors)."""
    out = SH.tree_map(lambda g, e: compressed_mean(g, e, group), grads, errors)
    means = SH.tree_map(lambda o: o[0], out)
    return means, SH.tree_map(lambda o: o[1], out)
