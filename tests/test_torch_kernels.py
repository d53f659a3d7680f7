"""The port's attention wrappers against the JAX package's Pallas kernels.

Inputs are made with numpy from a seed and handed to both packages.  The JAX
side runs its kernels in interpret mode, as tests/test_kernels.py does; on
the CPU the port's wrappers run their plain versions (the CUDA kernels are
held against those on the card by chip_smoke.py).
"""
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import _build, ops
from repro_torch.kernels import decode_attention as kdec
from repro_torch.kernels import ref as R

import _torch_threads  # noqa: F401  (one intra-op thread per test worker)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    # the tolerances of tests/test_kernels.py::_tol
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" else dict(rtol=2e-5, atol=2e-5)


def _pair(a: np.ndarray, name: str):
    jdt, tdt = DTYPES[name]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# -- flash attention -----------------------------------------------------------


@pytest.mark.parametrize("b,sq,hq,hkv,d", [
    (1, 128, 4, 4, 64),      # MHA, one block
    (2, 256, 8, 2, 64),      # GQA 4x, multi-block
    (1, 384, 5, 1, 128),     # MQA, odd heads, 3 blocks
    (2, 96, 4, 2, 32),       # ragged (96 < 128)
    (1, 320, 2, 2, 64),      # ragged (320)
    (1, 128, 2, 2, 96),      # phi3-mini's head dim, MHA
    (1, 130, 12, 1, 192),    # nemotron-4's head dim and group (G = 12), ragged
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_ref(b, sq, hq, hkv, d, dtype):
    rng = np.random.default_rng(1000 + b * 7 + sq + hq)
    qn = rng.standard_normal((b, sq, hq, d), np.float32)
    kn = rng.standard_normal((b, sq, hkv, d), np.float32)
    vn = rng.standard_normal((b, sq, hkv, d), np.float32)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, dtype) for a in (qn, kn, vn))
    want = jops.flash_attention(qj, kj, vj, causal=True, interpret=True)
    got = ops.flash_attention(qt, kt, vt)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


# -- decode attention ------------------------------------------------------------


@pytest.mark.parametrize("b,hq,hkv,m,d,block_m", [
    (2, 4, 4, 512, 64, 512),
    (2, 8, 2, 1024, 64, 256),
    (1, 4, 1, 300, 128, 512),   # ragged M (300)
    (4, 2, 2, 64, 32, 64),
    (2, 4, 4, 200, 96, 128),    # phi3-mini's head dim, MHA
    (2, 12, 1, 300, 192, 256),  # nemotron-4's head dim and group (G = 12)
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_ref(b, hq, hkv, m, d, block_m, dtype):
    rng = np.random.default_rng(2000 + b * 13 + hq + m)
    qn = rng.standard_normal((b, 1, hq, d), np.float32)
    kn = rng.standard_normal((b, m, hkv, d), np.float32)
    vn = rng.standard_normal((b, m, hkv, d), np.float32)
    lengths = rng.integers(1, m + 1, size=(b,)).astype(np.int32)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, dtype) for a in (qn, kn, vn))
    want = jops.decode_attention(qj, kj, vj, jnp.asarray(lengths), block_m=block_m,
                                 interpret=True)
    got = ops.decode_attention(qt, kt, vt, torch.from_numpy(lengths))
    assert got.dtype == qt.dtype and got.shape == qt.shape
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


def test_decode_attention_ignores_stale_cache():
    """Slots beyond ``lengths`` must not influence the output."""
    rng = np.random.default_rng(3)
    qn = rng.standard_normal((1, 1, 4, 32), np.float32)
    kn = rng.standard_normal((1, 128, 2, 32), np.float32)
    vn = rng.standard_normal((1, 128, 2, 32), np.float32)
    lengths = np.asarray([40], np.int32)
    base = ops.decode_attention(torch.from_numpy(qn), torch.from_numpy(kn),
                                torch.from_numpy(vn), torch.from_numpy(lengths))
    kp, vp = kn.copy(), vn.copy()
    kp[:, 40:] = 1e6  # poison the invalid region
    vp[:, 40:] = -1e6
    poisoned = ops.decode_attention(torch.from_numpy(qn), torch.from_numpy(kp),
                                    torch.from_numpy(vp), torch.from_numpy(lengths))
    np.testing.assert_allclose(_np(base), _np(poisoned), rtol=1e-6, atol=1e-6)
    want = jops.decode_attention(jnp.asarray(qn), jnp.asarray(kp), jnp.asarray(vp),
                                 jnp.asarray(lengths), block_m=64, interpret=True)
    np.testing.assert_allclose(_np(poisoned), _np(want), rtol=2e-5, atol=2e-5)


# -- plain versions against the JAX package's plain versions -------------------


def test_refs_match_jax_refs():
    from repro.kernels import ref as JR

    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 4, 40, 32), np.float32)
    k = rng.standard_normal((2, 2, 40, 32), np.float32)
    v = rng.standard_normal((2, 2, 40, 32), np.float32)
    np.testing.assert_allclose(
        _np(R.flash_attention_ref(*map(torch.from_numpy, (q, k, v)))),
        _np(JR.flash_attention_ref(*map(jnp.asarray, (q, k, v)))), rtol=2e-5, atol=2e-5)
    lengths = np.asarray([7, 40], np.int32)
    np.testing.assert_allclose(
        _np(R.decode_attention_ref(*map(torch.from_numpy, (q[:, :, 0], k, v, lengths)))),
        _np(JR.decode_attention_ref(*map(jnp.asarray, (q[:, :, 0], k, v, lengths)))),
        rtol=2e-5, atol=2e-5)


# -- the wrappers' argument checks (the kernels' contract) ---------------------


def _qkv(d=32, dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 8, 4, d, generator=g).to(dtype)
    k = torch.randn(1, 8, 2, d, generator=g).to(dtype)
    return q, k, k.clone()


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "mixed_dtype", "stride", "groups",
                                 "seq", "bf16_rows", "bf16_base"])
def test_flash_attention_rejects_what_the_kernel_does_not_take(bad):
    q, k, v = _qkv()
    if bad == "head_dim":
        q, k, v = _qkv(d=48)
    elif bad == "dtype":
        q, k, v = _qkv(dtype=torch.float16)
    elif bad == "mixed_dtype":
        v = v.to(torch.bfloat16)
    elif bad == "stride":
        q = torch.randn(1, 8, 4, 64)[..., ::2]
    elif bad == "groups":
        q = torch.randn(1, 8, 3, 32)
    elif bad == "seq":
        k, v = k[:, :5], v[:, :5]
    elif bad == "bf16_rows":  # the bf16 kernel loads 16-byte row vectors
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
        q = torch.zeros(1, 8, 4, 36, dtype=torch.bfloat16)[..., :32]
    elif bad == "bf16_base":  # TMA needs a 16-byte aligned base address
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
        k = torch.zeros(2 * k.numel() + 8, dtype=torch.bfloat16)[4:4 + k.numel()].view(k.shape)
    with pytest.raises((ValueError, TypeError)):
        ops.flash_attention(q, k, v)


@pytest.mark.parametrize("bad", ["lengths_dtype", "lengths_shape", "q_len", "group",
                                 "bf16_rows", "bf16_base"])
def test_decode_attention_rejects_what_the_kernel_does_not_take(bad):
    q = torch.randn(2, 1, 4, 32)
    ck = torch.randn(2, 16, 2, 32)
    lengths = torch.tensor([3, 16], dtype=torch.int32)
    if bad.startswith("bf16"):  # the bf16 kernel loads 16-byte row vectors by cp.async
        q, ck = q.to(torch.bfloat16), ck.to(torch.bfloat16)
    if bad == "lengths_dtype":
        lengths = lengths.long()
    elif bad == "lengths_shape":
        lengths = lengths[:1]
    elif bad == "q_len":
        q = torch.randn(2, 2, 4, 32)
    elif bad == "group":
        q = torch.randn(2, 1, 34, 32)
        ck = torch.randn(2, 16, 2, 32)
    elif bad == "bf16_rows":  # a slot stride of 36 elements: rows not 16-byte aligned
        ck = torch.zeros(2, 16, 2, 36, dtype=torch.bfloat16)[..., :32]
        ck = ck.as_strided((2, 16, 2, 32), (16 * 36 * 2 // 2, 36, 18, 1))
    elif bad == "bf16_base":
        q = torch.zeros(q.numel() + 4, dtype=torch.bfloat16)[4:].view(q.shape)
    with pytest.raises((ValueError, TypeError)):
        ops.decode_attention(q, ck, ck.clone(), lengths)


def test_decode_attention_takes_aligned_bf16_views():
    """The model's bf16 cache is a view of one (L, B, M, Hkv, D) buffer, and q a
    view of a projection: 16-byte aligned rows pass the bf16 checks."""
    cache = torch.zeros(2, 2, 16, 2, 32, dtype=torch.bfloat16)
    q = torch.zeros(2, 1, 4, 32, dtype=torch.bfloat16)
    lengths = torch.tensor([3, 16], dtype=torch.int32)
    kdec.check_args(q, cache[1], cache[0], lengths)
    out = ops.decode_attention(q, cache[1], cache[0], lengths)
    assert out.shape == q.shape and out.dtype == torch.bfloat16


def test_cpu_path_counts_no_launch():
    ops.reset_launches()
    q, k, v = _qkv()
    ops.flash_attention(q, k, v)
    ops.decode_attention(q[:, :1], k, v, torch.tensor([8], dtype=torch.int32))
    ops.ssm_scan(*_scan_args())
    ops.ssm_scan_fused(*_fused_args())
    assert ops.launches() == {"flash_attention": 0, "decode_attention": 0, "ssm_scan": 0,
                              "ssm_scan_fused": 0}
    assert set(ops.GRIDS_PER_CALL) == set(ops.KERNELS)


def _scan_args(b=2, s=5, di=8, n=4):
    g = torch.Generator().manual_seed(1)
    return (torch.rand(b, s, di, n, generator=g), torch.randn(b, s, di, n, generator=g),
            torch.randn(b, s, n, generator=g))


def _fused_args(b=2, s=5, di=8, n=4):
    g = torch.Generator().manual_seed(2)
    return (torch.rand(b, s, di, generator=g), torch.randn(b, s, n, generator=g),
            torch.randn(b, s, n, generator=g), torch.randn(b, s, di, generator=g),
            -torch.rand(di, n, generator=g))


@pytest.mark.parametrize("bad", ["dtype", "rank", "dbx_shape", "c_shape", "c_stride",
                                 "d_state", "noncontiguous"])
def test_ssm_scan_rejects_what_the_kernel_does_not_take(bad):
    dA, dBx, C = _scan_args()
    if bad == "dtype":
        dA = dA.double()
    elif bad == "rank":
        dA, dBx = dA[0], dBx[0]
    elif bad == "dbx_shape":
        dBx = dBx[:, :4]
    elif bad == "c_shape":
        C = C[:, :, :3]
    elif bad == "c_stride":
        C = torch.randn(2, 5, 8)[..., ::2]
    elif bad == "d_state":
        dA, dBx, C = _scan_args(n=3)
    elif bad == "noncontiguous":
        dA = torch.rand(2, 8, 5, 4).transpose(1, 2)
    with pytest.raises((ValueError, TypeError)):
        ops.ssm_scan(dA, dBx, C)


@pytest.mark.parametrize("bad", ["dtype", "bf16_x", "rank", "x_shape", "b_shape", "a_shape",
                                 "a_noncontiguous", "delta_stride", "d_state"])
def test_ssm_scan_fused_rejects_what_the_kernel_does_not_take(bad):
    delta, B, C, x, A = _fused_args()
    if bad == "dtype":
        delta = delta.double()
    elif bad == "bf16_x":
        x = x.to(torch.bfloat16)
    elif bad == "rank":
        delta = delta[0]
    elif bad == "x_shape":
        x = x[:, :4]
    elif bad == "b_shape":
        B = B[:1]
    elif bad == "a_shape":
        A = A[:7]
    elif bad == "a_noncontiguous":
        A = torch.rand(4, 8).t()
    elif bad == "delta_stride":
        delta = torch.rand(2, 5, 16)[..., ::2]
    elif bad == "d_state":
        delta, B, C, x, A = _fused_args(n=12)
    with pytest.raises((ValueError, TypeError)):
        ops.ssm_scan_fused(delta, B, C, x, A)


def test_ssm_scans_take_strided_c_and_b():
    """The model hands B and C as views of one projection (unit stride on N
    only): the kernels read them through strides, so the wrappers take them."""
    dA, dBx, C = _scan_args()
    bc = torch.randn(2, 5, 3 * 4)
    y0, h0 = ops.ssm_scan(dA, dBx, bc[..., 4:8].contiguous())
    y1, h1 = ops.ssm_scan(dA, dBx, bc[..., 4:8])
    assert torch.equal(y0, y1) and torch.equal(h0, h1)
    delta, _, _, x, A = _fused_args()
    y0, _ = ops.ssm_scan_fused(delta, bc[..., :4].contiguous(), bc[..., 4:8].contiguous(), x, A)
    y1, _ = ops.ssm_scan_fused(delta, bc[..., :4], bc[..., 4:8], x, A)
    assert torch.equal(y0, y1)


@pytest.mark.parametrize("b,hkv,m", [(8, 1, 1024), (8, 5, 1024), (3, 2, 300), (1, 1, 7),
                                     (64, 8, 32768), (2, 1, 512), (1, 1, 1), (4, 4, 64),
                                     (16, 1, 2048), (1, 8, 4096), (200, 1, 96)])
def test_decode_split_plan_covers_the_cache(b, hkv, m):
    """The plan of both dtypes: n_split from (B, Hkv, SM count) alone, each
    block's range sized on the device from lengths[b] (``split_range``, the
    arithmetic both kernels of csrc/decode_attention.cu compute).  Every slot
    below the length falls in exactly one split, no block reads at or past
    it, whatever the length: 0, 1, below n_split, M, and past M (clamped)."""
    n_split = kdec.n_splits(b, hkv, n_sm=132)
    assert 1 <= n_split <= kdec.MAX_SPLIT
    for length in sorted({0, 1, 2, n_split - 1, n_split, n_split + 1, m // 2 + 3, m - 1, m,
                          m + 5}):
        covered = []
        for sp in range(n_split):
            start, end = kdec.split_range(length, m, n_split, sp)
            assert 0 <= start <= end <= min(length, m)
            covered.extend(range(start, end))
        assert covered == list(range(min(max(length, 0), m)))


def test_build_needs_nvcc_and_import_builds_nothing(monkeypatch, tmp_path):
    assert _build.library.cache_info().currsize == 0  # the CPU path never loads it
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc_path()
    names = {p.name for p in _build.sources()}
    assert names == {"flash_attention.cu", "decode_attention.cu", "ssm_scan.cu"}
    assert (_build.CSRC / "hopper.cuh").is_file()  # in the build's digest with the sources
    for name in ("repro_ssm_scan_fwd", "repro_ssm_scan_fused_fwd"):
        assert name in _build.SIGNATURES
    assert "-gencode" in _build.NVCC_FLAGS and "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_concurrent_cold_calls_build_the_library_once(monkeypatch):
    """Two threads calling ``library()`` cold (two serve replicas starting at
    once) run one build and get the same loaded library."""
    builds = []

    def slow_build():
        builds.append(threading.get_ident())
        time.sleep(0.2)  # the second caller arrives while the first builds
        return _build.BUILD_DIR / "libfake.so", "", 0.2

    def fake_cdll(path):
        return types.SimpleNamespace(path=path, **{n: types.SimpleNamespace()
                                                   for n in _build.SIGNATURES})

    monkeypatch.setattr(_build, "build", slow_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", fake_cdll)
    _build.library.cache_clear()
    _build._load.cache_clear()
    try:
        start = threading.Barrier(2)
        got = []

        def call():
            start.wait()
            got.append(_build.library())

        threads = [threading.Thread(target=call) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in threads)
        assert len(builds) == 1, builds
        assert len(got) == 2 and got[0] is got[1]
        assert got[0].repro_flash_attention_fwd.restype is _build.ctypes.c_int
    finally:
        _build.library.cache_clear()
        _build._load.cache_clear()
