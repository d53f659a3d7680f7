"""Launcher for K2, the flash-decode CUDA kernel (``csrc/decode_attention.cu``),
the port of the Pallas TPU kernel ``repro.kernels.decode_attention._decode_kernel``.

The cache is read in place in the model's (B, M, Hkv, D) layout.  The slots
are split across blocks (flash-decoding) so that a small batch with few KV
heads still fills the card: ``n_splits`` picks the number of splits from
(B, Hkv, SM count), and each block sizes its own range from ``lengths[b]`` on
the device (``split_range``).  Each block writes a partial (m, l, acc) to f32
scratch allocated here, and a second grid combines the partials.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import DTYPES, HEAD_DIMS

MAX_GROUP = 16      # most query heads per KV head (kGMax in the .cu)
MAX_SPLIT = 256     # most splits


def check_args(q: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
               lengths: torch.Tensor) -> None:
    """Raise on anything the kernel does not take (checked on every device)."""
    if q.ndim != 4 or q.shape[1] != 1:
        raise ValueError(f"decode_attention wants q (B,1,Hq,D); got {tuple(q.shape)}")
    b, _, hq, d = q.shape
    if cache_k.ndim != 4 or cache_k.shape != cache_v.shape or cache_k.shape[0] != b \
            or cache_k.shape[3] != d:
        raise ValueError(f"cache {tuple(cache_k.shape)}/{tuple(cache_v.shape)} does not match "
                         f"q {tuple(q.shape)}: want (B,M,Hkv,D)")
    hkv = cache_k.shape[2]
    if hkv == 0 or hq % hkv or hq // hkv > MAX_GROUP:
        raise ValueError(f"Hq={hq}, Hkv={hkv}: want Hkv | Hq and Hq/Hkv <= {MAX_GROUP}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if q.dtype not in DTYPES or cache_k.dtype != q.dtype or cache_v.dtype != q.dtype:
        raise TypeError(f"dtypes {q.dtype}/{cache_k.dtype}/{cache_v.dtype}: "
                        f"want one of {list(DTYPES)}")
    if lengths.shape != (b,) or lengths.dtype != torch.int32:
        raise ValueError(f"lengths must be (B,) int32; got {tuple(lengths.shape)} {lengths.dtype}")
    if not (q.device == cache_k.device == cache_v.device == lengths.device):
        raise ValueError("q, cache and lengths must share a device")
    for name, t in (("q", q), ("cache_k", cache_k), ("cache_v", cache_v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} needs unit stride on D; strides {t.stride()}")
        # the bf16 kernel loads rows in 16-byte vectors (cp.async)
        if t.dtype == torch.bfloat16 and (t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3])):
            raise ValueError(f"bf16 {name} needs 16-byte aligned rows; strides {t.stride()}")
    if not lengths.is_contiguous():
        raise ValueError("lengths must be contiguous")


@functools.lru_cache(maxsize=None)
def _sm_count(device_index) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def n_splits(batch: int, hkv: int, n_sm: int) -> int:
    """Splits per (b, kv head): a block an SM, from the grid's other
    dimensions and the card alone (reading the lengths here would cost a
    sync)."""
    return max(1, min(MAX_SPLIT, math.ceil(n_sm / (batch * hkv))))


def split_range(length: int, m: int, n_split: int, sp: int) -> tuple[int, int]:
    """The slots [start, end) that split ``sp`` of a row with ``lengths[b] ==
    length`` reads.  This is the kernels' contract: both kernels of
    csrc/decode_attention.cu compute it on the device in the same way."""
    n = max(0, min(length, m))
    chunk = -(-n // n_split)
    start = min(sp * chunk, n)
    return start, min(start + chunk, n)


def decode_attention_bmhd(q: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
                          lengths: torch.Tensor) -> torch.Tensor:
    """q: (B,1,Hq,D); cache_{k,v}: (B,M,Hkv,D); lengths (B,) int32, CUDA
    -> (B,1,Hq,D) in q's dtype.  Slots at or past ``lengths`` are not read."""
    check_args(q, cache_k, cache_v, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors; got {q.device}")
    b, _, hq, d = q.shape
    m, hkv = cache_k.shape[1], cache_k.shape[2]
    out = torch.empty((b, 1, hq, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    n_split = n_splits(b, hkv, _sm_count(q.device.index))
    part_m = torch.empty((b, hq, n_split), dtype=torch.float32, device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((b, hq, n_split, d), dtype=torch.float32, device=q.device)
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_decode_attention_fwd(
            q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(), lengths.data_ptr(),
            part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(), out.data_ptr(),
            b, m, hq, hkv, d, n_split,
            q.stride(0), q.stride(2), cache_k.stride(0), cache_k.stride(1), cache_k.stride(2),
            cache_v.stride(0), cache_v.stride(1), cache_v.stride(2), out.stride(0),
            out.stride(2), DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA error {err}")
    return out
