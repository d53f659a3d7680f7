"""The port's attention wrappers against the JAX package's Pallas kernels.

Inputs are made with numpy from a seed and handed to both packages.  The JAX
side runs its kernels in interpret mode, as tests/test_kernels.py does; on
the CPU the port's wrappers run their plain versions (the CUDA kernels are
held against those on the card by chip_smoke.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import _build, ops
from repro_torch.kernels import decode_attention as kdec
from repro_torch.kernels import ref as R

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
                                 "seq", "bf16_rows"])
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
    with pytest.raises((ValueError, TypeError)):
        ops.flash_attention(q, k, v)


@pytest.mark.parametrize("bad", ["lengths_dtype", "lengths_shape", "q_len", "group"])
def test_decode_attention_rejects_what_the_kernel_does_not_take(bad):
    q = torch.randn(2, 1, 4, 32)
    ck = torch.randn(2, 16, 2, 32)
    lengths = torch.tensor([3, 16], dtype=torch.int32)
    if bad == "lengths_dtype":
        lengths = lengths.long()
    elif bad == "lengths_shape":
        lengths = lengths[:1]
    elif bad == "q_len":
        q = torch.randn(2, 2, 4, 32)
    elif bad == "group":
        q = torch.randn(2, 1, 34, 32)
        ck = torch.randn(2, 16, 2, 32)
    with pytest.raises((ValueError, TypeError)):
        ops.decode_attention(q, ck, ck.clone(), lengths)


def test_cpu_path_counts_no_launch():
    ops.reset_launches()
    q, k, v = _qkv()
    ops.flash_attention(q, k, v)
    ops.decode_attention(q[:, :1], k, v, torch.tensor([8], dtype=torch.int32))
    assert ops.launches() == {"flash_attention": 0, "decode_attention": 0}


@pytest.mark.parametrize("b,hkv,m", [(8, 1, 1024), (3, 2, 300), (1, 1, 7), (64, 8, 32768)])
def test_decode_split_plan_covers_the_cache(b, hkv, m):
    split_len, n_split = kdec.split_plan(b, hkv, m, n_sm=132)
    assert split_len % kdec.SLOT_TILE == 0
    assert split_len * n_split >= m > split_len * (n_split - 1)
    assert n_split < 65536  # a grid's z dimension


def test_build_needs_nvcc_and_import_builds_nothing(monkeypatch, tmp_path):
    assert _build.library.cache_info().currsize == 0  # the CPU path never loads it
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc_path()
    names = {p.name for p in _build.sources()}
    assert names == {"flash_attention.cu", "decode_attention.cu"}
    assert "-gencode" in _build.NVCC_FLAGS and "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
