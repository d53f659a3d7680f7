"""Model-layout wrappers around the attention kernels, with launch counters.

Port of the attention half of ``repro.kernels.ops``.  Layout contract with
``repro_torch.models.layers``: activations are (B, S, H, D), caches are
(B, M, Hkv, D).

Dispatch is by the device of the tensors and nothing else: a CPU tensor goes
to the plain version in ``ref``; a CUDA tensor launches the CUDA kernel or
raises.  The arguments are checked once per call: by the launcher on the
card, by the same ``check_args`` here on the CPU.  Each wrapper's
``launches`` attribute counts the calls that launched its kernel (the plain
version is not counted); one K2 call runs two grids, split and combine.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.decode_attention import check_args as _check_decode
from repro_torch.kernels.decode_attention import decode_attention_bmhd
from repro_torch.kernels.flash_attention import check_args as _check_flash
from repro_torch.kernels.flash_attention import flash_attention_bshd


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal GQA attention.  q: (B,S,Hq,D); k,v: (B,S,Hkv,D) -> (B,S,Hq,D)."""
    if q.device.type == "cpu":
        _check_flash(q, k, v)
        out = _ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                       v.transpose(1, 2))
        return out.transpose(1, 2)
    out = flash_attention_bshd(q, k, v)
    flash_attention.launches += 1
    return out


def decode_attention(q: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """q: (B,1,Hq,D); cache_{k,v}: (B,M,Hkv,D); lengths (B,) int32 ->
    (B,1,Hq,D).  Cache slots at or past ``lengths`` are masked."""
    if q.device.type == "cpu":
        _check_decode(q, cache_k, cache_v, lengths)
        out = _ref.decode_attention_ref(q[:, 0], cache_k.transpose(1, 2),
                                        cache_v.transpose(1, 2), lengths)
        return out[:, None]
    out = decode_attention_bmhd(q, cache_k, cache_v, lengths)
    decode_attention.launches += 1
    return out


flash_attention.launches = 0
decode_attention.launches = 0
KERNELS = {"flash_attention": flash_attention, "decode_attention": decode_attention}
# __global__ kernels one wrapper call launches
GRIDS_PER_CALL = {"flash_attention": 1, "decode_attention": 2}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launches() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}
