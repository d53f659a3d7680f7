"""Plain PyTorch versions of the attention kernels (the allclose reference).

Port of the attention half of ``repro.kernels.ref``: ``-inf`` masking, f32
softmax, output in q's dtype.  The wrappers in ``ops`` use these for tensors
that lie on the CPU; ``chip_smoke.py`` holds each CUDA kernel against them.
"""
from __future__ import annotations

import math

import torch


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal.  q: (B,Hq,Sq,D); k,v: (B,Hkv,Sk,D); GQA by head repetition.
    Returns (B,Hq,Sq,D).  f32 softmax, output in q.dtype."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    kr = k.repeat_interleave(group, dim=1).float()
    vr = v.repeat_interleave(group, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr) / math.sqrt(d)
    iq = torch.arange(sq, device=q.device)[:, None]
    ik = torch.arange(sk, device=q.device)[None, :]
    s = s.masked_fill(ik > iq, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vr).to(q.dtype)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """q: (B,Hq,D); k,v: (B,Hkv,M,D); lengths: (B,) valid slots.
    Returns (B,Hq,D)."""
    b, hq, d = q.shape
    hkv, m = k.shape[1], k.shape[2]
    group = hq // hkv
    kr = k.repeat_interleave(group, dim=1).float()
    vr = v.repeat_interleave(group, dim=1).float()
    s = torch.einsum("bhd,bhmd->bhm", q.float(), kr) / math.sqrt(d)
    mask = torch.arange(m, device=q.device)[None, None, :] < lengths.to(q.device)[:, None, None]
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhm,bhmd->bhd", p, vr).to(q.dtype)
