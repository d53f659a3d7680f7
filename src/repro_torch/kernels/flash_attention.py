"""Launcher for K1, the causal GQA flash-attention CUDA kernel
(``csrc/flash_attention.cu``), the port of the Pallas TPU kernel
``repro.kernels.flash_attention._flash_kernel``.

The kernel reads the model's (B, S, H, D) layout through strides, masks the
ragged end of S itself and reads K/V once per head group, so this launcher
makes no transpose, padding or repeat copies: it checks its arguments,
allocates the output and launches on the current stream.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (16, 32, 64, 96, 128, 192, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise on anything the kernel does not take.  Called for every device,
    so the CPU tests hold the model's tensors to the kernel's contract."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"flash_attention wants (B,S,H,D) tensors; got {q.shape}, "
                         f"{k.shape}, {v.shape}")
    b, s, hq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[1] != s or k.shape[3] != d:
        raise ValueError(f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not match q {tuple(q.shape)} "
                         "(self-attention: Sq == Sk)")
    hkv = k.shape[2]
    if hkv == 0 or hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: want one of {list(DTYPES)}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"devices differ: {q.device}, {k.device}, {v.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} needs unit stride on D; strides {t.stride()}")
        # the bf16 kernel loads rows in 16-byte vectors
        if t.dtype == torch.bfloat16 and (t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3])):
            raise ValueError(f"bf16 {name} needs 16-byte aligned rows; strides {t.stride()}")


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q: (B,S,Hq,D); k,v: (B,S,Hkv,D), CUDA -> (B,S,Hq,D) in q's dtype."""
    check_args(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors; got {q.device}")
    b, s, hq, d = q.shape
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if q.numel() == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, s, hq, k.shape[2], d,
            q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2), out.stride(0), out.stride(1), out.stride(2),
            DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    return out
