"""Mamba-style selective-scan SSM mixer (hymba's parallel-head partner).

Port of ``repro.models.ssm``.  ``ssm_forward`` runs the recurrence over the
whole sequence; decode carries (conv_state, ssm_state) and is O(1) per token
(plain PyTorch: one step has no kernel behind it in the reference either).

``cfg.ssm.scan_impl`` picks the scan as the reference does, and each choice
computes what its JAX counterpart computes.  Prefill (``train=False``, run
under ``no_grad``) takes a scan kernel:

- ``"assoc"`` (default): discretise to dA, dBx (B,S,di,N) in plain PyTorch,
  then K4 (``ops.ssm_scan``) runs the recurrence (the reference runs an
  associative scan in XLA);
- ``"chunked"`` / ``"chunked_u"``: K3 (``ops.ssm_scan_fused``) discretises
  per step inside the kernel (the reference streams chunks in XLA).

Training (``train=True``) computes the reference's own XLA scans in plain
PyTorch ops that autograd differentiates, on every device: the kernels have
no backward.  ``"assoc"`` is one associative scan over S
(``_associative_scan``); ``"chunked"`` / ``"chunked_u"`` is
``_chunked_selective_scan``, an associative scan within each chunk of
``cfg.ssm.chunk`` steps plus the carried state's prefix correction.

On a mesh (DTensor inputs, ``steps.py``) K3 and K4 run in ``local_map``
islands on each rank's local ``d_inner`` channels, the batch over the dp
axes where it divides: the recurrence is per channel, so the local scans
are exact.  Their outputs keep the layout of the cache's ``ssm`` state
(``sharding.cache_pspecs``).  The decode step is plain DTensor ops, and
so are training's differentiable scans: they slice and concatenate along S
and combine channel by channel, so ``d_inner`` keeps its shard and autograd
runs on each rank's channels.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch import sharding as SH
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import adtype
from repro_torch.models.params import ParamDef

Params = Dict[str, Any]
SCAN_IMPLS = ("assoc", "chunked", "chunked_u")


def ssm_defs(cfg) -> Params:
    s = cfg.ssm
    d, di, n, k = cfg.d_model, s.d_inner(cfg.d_model), s.d_state, s.d_conv
    dt = adtype(cfg)
    dt_rank = max(d // 16, 1)
    return {
        "in_proj": ParamDef((d, 2 * di), ("embed", "inner"), dtype=dt),
        "conv_w": ParamDef((k, di), (None, "inner"), init="scaled", scale=0.5, dtype=dt),
        "conv_b": ParamDef((di,), ("inner",), init="zeros", dtype=dt),
        "x_proj": ParamDef((di, dt_rank + 2 * n), ("inner", None), dtype=dt),
        "dt_proj": ParamDef((dt_rank, di), (None, "inner"), dtype=dt),
        "dt_bias": ParamDef((di,), ("inner",), init="scaled", scale=1.0, dtype=torch.float32),
        "A_log": ParamDef((di, n), ("inner", None), init="scaled", scale=1.0,
                          dtype=torch.float32),
        "D": ParamDef((di,), ("inner",), init="ones", dtype=torch.float32),
        "out_proj": ParamDef((di, d), ("inner", "embed"), dtype=dt),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d.  x: (B,S,di); w: (k,di).  Returns (y, new_state)
    where state holds the last k-1 inputs (B,k-1,di)."""
    k, s = w.shape[0], x.shape[1]
    if state is None:
        state = SH.zeros_beside(x, (x.shape[0], k - 1, x.shape[2]), 1)
    xp = torch.cat([state, x], dim=1)  # (B, S+k-1, di)
    y = xp[:, 0:s] * w[0]  # summed tap by tap, in the reference's order
    for i in range(1, k):
        y = y + xp[:, i:i + s] * w[i]
    y = y + b
    new_state = xp[:, -(k - 1):] if k > 1 else state
    return y, new_state


def _sel_params(p: Params, x: torch.Tensor, cfg
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (..., di) -> (delta (...,di), B (...,n), C (...,n)), all f32."""
    n = cfg.ssm.d_state
    dt_rank = p["dt_proj"].shape[0]
    proj = x @ p["x_proj"]  # (..., dt_rank + 2n), in the activation dtype
    dt_in, bc = proj[..., :dt_rank], proj[..., dt_rank:]
    delta = F.softplus(dt_in.float() @ p["dt_proj"].float() + p["dt_bias"])
    return delta, bc[..., :n].float(), bc[..., n:].float()


def _discretize(delta: torch.Tensor, B: torch.Tensor, x: torch.Tensor, A: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ZOH discretisation: dA = exp(delta A), dBx = delta B x, both (B,S,di,n)
    f32, from delta, x (B,S,di), B (B,S,n) and A (di,n)."""
    return torch.exp(delta[..., None] * A), delta[..., None] * B[:, :, None, :] * x[..., None]


def _associative_scan(a: torch.Tensor, b: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan over axis 1 of the linear recurrence's pairs under
    ``(a1, b1) . (a2, b2) = (a1 a2, b1 a2 + b2)``, in ceil(log2 S) levels:
    level l combines each step with the partial product ``2^l`` steps before
    it.  Returns (prod a, h): h_t = a_t h_{t-1} + b_t from h_{-1} = 0."""
    off = 1
    while off < a.shape[1]:
        a_cur, b_cur = a[:, off:], b[:, off:]
        b = torch.cat([b[:, :off], b[:, :-off] * a_cur + b_cur], dim=1)
        a = torch.cat([a[:, :off], a[:, :-off] * a_cur], dim=1)
        off *= 2
    return a, b


def _chunked_selective_scan(delta: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                            xf: torch.Tensor, A: torch.Tensor, chunk: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``_chunked_selective_scan``: the recurrence in
    (B,chunk,di,n) tiles with a carried state.  S is padded to a multiple of
    the chunk with zero steps (delta = 0: dA = 1, dBx = 0, identity steps
    that leave the state as it is).  Returns (y (B,S,di), h_last (B,di,n))."""
    b, s, di = xf.shape
    c = min(chunk, s)
    pad = (-s) % c
    if pad:
        delta, B, C, xf = (F.pad(t, (0, 0, 0, pad)) for t in (delta, B, C, xf))
    h = torch.zeros((b, di, A.shape[1]), dtype=torch.float32, device=xf.device)
    ys = []
    for lo in range(0, s + pad, c):
        sl = slice(lo, lo + c)
        pa, hs = _associative_scan(*_discretize(delta[:, sl], B[:, sl], xf[:, sl], A))
        hs = hs + pa * h[:, None]  # prefix correction
        ys.append(torch.einsum("bsdn,bsn->bsd", hs, C[:, sl]))
        h = hs[:, -1]
    return torch.cat(ys, dim=1)[:, :s], h


def ssm_forward(p: Params, x: torch.Tensor, cfg, train: bool = False
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence selective scan.  x: (B,S,d) -> (y (B,S,d), final state
    {conv (B,k-1,di), ssm (B,di,n) f32}).  ``train`` picks the
    differentiable scans over the kernels (see the module docstring)."""
    xz = x @ p["in_proj"]
    di = xz.shape[-1] // 2
    xs, z = xz[..., :di], xz[..., di:]
    xs, conv_state = _causal_conv(xs, p["conv_w"], p["conv_b"])
    xs = F.silu(xs)
    delta, B, C = _sel_params(p, xs, cfg)
    A = -torch.exp(p["A_log"])  # (di, n)
    xf = xs.float()

    impl = cfg.ssm.scan_impl
    if impl not in SCAN_IMPLS:
        raise ValueError(f"scan_impl={impl!r}; the port has {SCAN_IMPLS}")
    if train and impl == "assoc":
        _, h = _associative_scan(*_discretize(delta, B, xf, A))
        y, h_last = torch.einsum("bsdn,bsn->bsd", h, C), h[:, -1]
    elif train:
        y, h_last = _chunked_selective_scan(delta, B, C, xf, A, cfg.ssm.chunk)
    elif impl == "assoc":
        y, h_last = _scan(kops.ssm_scan, *_discretize(delta, B, xf, A), C)  # K4
    else:
        y, h_last = _scan(kops.ssm_scan_fused, delta, B, C, xf, A)  # K3
    y = y + p["D"] * xf
    y = y.to(x.dtype) * F.silu(z)
    return y @ p["out_proj"], {"conv": conv_state, "ssm": h_last}


def _scan(kernel, *args: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4 ``(dA, dBx, C)`` or K3 ``(delta, B, C, x, A)``; on a mesh in a
    ``local_map`` island, each rank on its local channels."""
    if not isinstance(args[0], DTensor):
        return kernel(*args)
    mesh, b, di = args[0].device_mesh, args[0].shape[0], args[0].shape[2]
    bt = "dp" if b % SH.dp_size(mesh) == 0 else None
    ch = "model" if di % SH.mesh_shape(mesh).get("model", 1) == 0 else None

    def lay(*spec):
        return SH.kernel_layout(mesh, spec)

    per_step = lay(bt, None, None)  # B, C: (B,S,N), every channel's
    if kernel is kops.ssm_scan:
        ins = (lay(bt, None, ch, None), lay(bt, None, ch, None), per_step)
    else:
        ins = (lay(bt, None, ch), per_step, per_step, lay(bt, None, ch), lay(ch, None))
    return SH.local_call(kernel, ins, (lay(bt, None, ch), lay(bt, ch, None)), *args)


def ssm_decode(p: Params, x: torch.Tensor, state: Dict[str, torch.Tensor], cfg
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-token step.  x: (B,1,d); state: {conv (B,k-1,di), ssm (B,di,n)}.
    Returns (y (B,1,d), new state); ``state`` is not written."""
    xz = x @ p["in_proj"]
    di = xz.shape[-1] // 2
    xs, z = xz[..., :di], xz[..., di:]
    xs, conv_state = _causal_conv(xs, p["conv_w"], p["conv_b"], state["conv"])
    xs = F.silu(xs)
    delta, B, C = _sel_params(p, xs[:, 0], cfg)  # (B,di), (B,n), (B,n)
    A = -torch.exp(p["A_log"])
    dA = torch.exp(delta[..., None] * A)  # (B,di,n)
    xf = xs[:, 0].float()
    h = state["ssm"] * dA + delta[..., None] * B[:, None, :] * xf[..., None]
    y = torch.einsum("bdn,bn->bd", h, C) + p["D"] * xf
    y = (y.to(x.dtype) * F.silu(z[:, 0]))[:, None]
    return y @ p["out_proj"], {"conv": conv_state, "ssm": h}


def init_ssm_state(cfg, batch: int, device="cuda") -> Dict[str, torch.Tensor]:
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    return {
        "conv": torch.zeros((batch, s.d_conv - 1, di), dtype=adtype(cfg), device=device),
        "ssm": torch.zeros((batch, di, s.d_state), dtype=torch.float32, device=device),
    }
