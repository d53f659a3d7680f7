"""Launchers for K4 and K3, the selective-scan CUDA kernels
(``csrc/ssm_scan.cu``), the ports of the Pallas TPU kernels
``repro.kernels.ssm_scan._ssm_kernel`` and ``_ssm_fused_kernel``.

K4 walks the whole sequence with one thread per (b, d, n) state channel.  K3
is a chunked scan: chunks of ``SCAN_CHUNK`` steps are scanned in parallel,
composed in order, and scanned again from their carried-in state
(``scan_chunks`` is the plan).  Both take any S as it is: unlike the JAX
wrappers, these make no padding copies.  They check their arguments,
allocate y and h_last and launch on the current stream.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from repro_torch.kernels import _build

STATE_DIMS = (1, 2, 4, 8, 16, 32)  # N: one aligned group of lanes per d channel
MAX_BATCH = 65535                  # the grid's y dimension
SCAN_CHUNK = 32                    # K3: steps per chunk (kL in the .cu)


def scan_chunks(s: int) -> List[Tuple[int, int]]:
    """K3's chunk plan: the steps ``[start, end)`` of each chunk of a scan of
    ``s`` steps, in the order their carries compose.  This is the kernel's
    contract: ``ssm_scan_fused_kernel`` in csrc/ssm_scan.cu computes the same
    on the device.  The chunks are ``SCAN_CHUNK`` steps long, counted from
    t = 0 whatever ``s`` is; the last one may be shorter.

    1. Local scans: each chunk c runs h_t = exp(delta_t A) h_{t-1} +
       delta_t B_t x_t from h = 0 over its steps, giving its end state
       ``end[c]``, and sums its delta in step order, ``sum[c]``.
    2. The carry, in order of c: ``h_in[0] = 0``, ``h_in[c + 1] =
       exp(A sum[c]) h_in[c] + end[c]``: the affine maps of the chunks
       composed, (a2, b2) o (a1, b1) = (a2 a1, a2 b1 + b2).
    3. Re-runs: each chunk runs again from ``h_in[c]`` and gives
       y_t = <h_t, C_t> for its steps.  ``h_last = h_in[len(plan)]``.

    The chunks do not move with S, and a step with delta = 0 changes
    neither h nor a sum (exp(0) = 1, and adding 0 is exact): so a scan whose
    last steps have delta = 0 gives y and h_last bit for bit as the scan
    without them (the JAX wrappers pad S with such steps)."""
    return [(t, min(t + SCAN_CHUNK, s)) for t in range(0, s, SCAN_CHUNK)]


def _check_common(name: str, tensors, b: int, n: int) -> None:
    for key, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {key} is {t.dtype}; the kernel takes float32 only")
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {sorted(map(str, devices))}")
    if n not in STATE_DIMS:
        raise ValueError(f"{name}: d_state {n} not in {STATE_DIMS}")
    if b > MAX_BATCH:
        raise ValueError(f"{name}: batch {b} > {MAX_BATCH}")


def _check_seq(name: str, key: str, t: torch.Tensor, shape) -> None:
    """A (B,S,W) input read through its (batch, seq) strides."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, want {tuple(shape)}")
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"{name}: {key} needs unit stride on its last dim; strides {t.stride()}")


def check_scan_args(dA: torch.Tensor, dBx: torch.Tensor, C: torch.Tensor) -> None:
    """K4's contract: dA, dBx (B,S,di,N) f32 contiguous; C (B,S,N) f32.
    Called for every device, so the CPU tests hold the model's tensors to it."""
    if dA.ndim != 4:
        raise ValueError(f"ssm_scan wants dA (B,S,di,N); got {tuple(dA.shape)}")
    b, s, di, n = dA.shape
    _check_common("ssm_scan", {"dA": dA, "dBx": dBx, "C": C}, b, n)
    if tuple(dBx.shape) != tuple(dA.shape):
        raise ValueError(f"ssm_scan: dBx {tuple(dBx.shape)} does not match dA {tuple(dA.shape)}")
    for key, t in (("dA", dA), ("dBx", dBx)):
        if not t.is_contiguous():
            raise ValueError(f"ssm_scan: {key} must be contiguous; strides {t.stride()}")
    _check_seq("ssm_scan", "C", C, (b, s, n))


def check_fused_args(delta: torch.Tensor, B: torch.Tensor, C: torch.Tensor, x: torch.Tensor,
                     A: torch.Tensor) -> None:
    """K3's contract: delta, x (B,S,di); B, C (B,S,N); A (di,N) contiguous;
    all f32."""
    if delta.ndim != 3 or A.ndim != 2:
        raise ValueError(f"ssm_scan_fused wants delta (B,S,di) and A (di,N); got "
                         f"{tuple(delta.shape)}, {tuple(A.shape)}")
    b, s, di = delta.shape
    n = A.shape[1]
    _check_common("ssm_scan_fused", {"delta": delta, "B": B, "C": C, "x": x, "A": A}, b, n)
    if A.shape[0] != di or not A.is_contiguous():
        raise ValueError(f"ssm_scan_fused: A must be ({di}, N) and contiguous; got "
                         f"{tuple(A.shape)} strides {A.stride()}")
    _check_seq("ssm_scan_fused", "delta", delta, (b, s, di))
    _check_seq("ssm_scan_fused", "x", x, (b, s, di))
    _check_seq("ssm_scan_fused", "B", B, (b, s, n))
    _check_seq("ssm_scan_fused", "C", C, (b, s, n))


def _outputs(b: int, s: int, di: int, n: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    y = torch.empty((b, s, di), dtype=torch.float32, device=device)
    h_last = torch.empty((b, di, n), dtype=torch.float32, device=device)
    return y, h_last


def _launch(name: str, fn, *args, device) -> None:
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def ssm_scan_bsdn(dA: torch.Tensor, dBx: torch.Tensor, C: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4.  dA, dBx: (B,S,di,N); C: (B,S,N); CUDA, f32 -> (y (B,S,di),
    h_last (B,di,N)) f32, h starting at 0."""
    check_scan_args(dA, dBx, C)
    if dA.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors; got {dA.device}")
    b, s, di, n = dA.shape
    y, h_last = _outputs(b, s, di, n, dA.device)
    if h_last.numel() == 0:
        return y, h_last
    _launch("ssm_scan", _build.library().repro_ssm_scan_fwd,
            dA.data_ptr(), dBx.data_ptr(), C.data_ptr(), y.data_ptr(), h_last.data_ptr(),
            b, s, di, n, C.stride(0), C.stride(1), device=dA.device)
    return y, h_last


def ssm_scan_fused_bsd(delta: torch.Tensor, B: torch.Tensor, C: torch.Tensor, x: torch.Tensor,
                       A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3.  delta, x: (B,S,di); B, C: (B,S,N); A: (di,N); CUDA, f32 ->
    (y (B,S,di), h_last (B,di,N)) f32, h starting at 0."""
    check_fused_args(delta, B, C, x, A)
    if delta.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors; got {delta.device}")
    b, s, di = delta.shape
    n = A.shape[1]
    y, h_last = _outputs(b, s, di, n, delta.device)
    if h_last.numel() == 0:
        return y, h_last
    _launch("ssm_scan_fused", _build.library().repro_ssm_scan_fused_fwd,
            delta.data_ptr(), B.data_ptr(), C.data_ptr(), x.data_ptr(), A.data_ptr(),
            y.data_ptr(), h_last.data_ptr(), b, s, di, n,
            delta.stride(0), delta.stride(1), B.stride(0), B.stride(1),
            C.stride(0), C.stride(1), x.stride(0), x.stride(1), device=delta.device)
    return y, h_last
