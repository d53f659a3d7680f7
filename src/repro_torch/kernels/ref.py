"""Plain PyTorch versions of the kernels (the allclose reference).

Port of ``repro.kernels.ref``: for attention ``-inf`` masking, f32 softmax,
output in q's dtype; for the selective scan the discretisation and the
recurrence in f32.  The wrappers in ``ops`` use these for tensors that lie on
the CPU; ``chip_smoke.py`` holds each CUDA kernel against them.
"""
from __future__ import annotations

import math
from typing import Tuple

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


def ssm_discretize(delta: torch.Tensor, B: torch.Tensor, x: torch.Tensor,
                   A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """ZOH discretisation: dA_t = exp(delta_t*A); dBx_t = delta_t*B_t*x_t.

    delta, x: (B,S,di); B: (B,S,N); A: (di,N) -> dA, dBx (B,S,di,N).  The
    fused scan kernel computes the same per step in registers."""
    dA = torch.exp(delta[..., None] * A)
    dBx = delta[..., None] * B[:, :, None, :] * x[..., None]
    return dA, dBx


def ssm_scan_ref(dA: torch.Tensor, dBx: torch.Tensor, C: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Linear recurrence h_t = dA_t * h_{t-1} + dBx_t, h_{-1} = 0;
    y_t = <h_t, C_t>.

    dA, dBx: (B,S,di,N) f32;  C: (B,S,N) f32.
    Returns (y (B,S,di) f32, h_last (B,di,N) f32).  One step at a time: the
    oracle, not a fast path."""
    b, s, di, n = dA.shape
    h = torch.zeros((b, di, n), dtype=torch.float32, device=dA.device)
    y = torch.empty((b, s, di), dtype=torch.float32, device=dA.device)
    for t in range(s):
        h = dA[:, t] * h + dBx[:, t]
        y[:, t] = torch.einsum("bdn,bn->bd", h, C[:, t])
    return y, h
