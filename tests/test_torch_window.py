"""The port's sliding-window mode (``window > 0``, a circular KV buffer)
against the JAX package's, on the CPU at smoke size in f32: windowed
attention for prefill and decode, and hymba-smoke (window 16) prefilled at
8, 16, 20 and 32 tokens and decoded 20 steps past the wrap, on both scan
impls and both attention routes.

Params are made by the JAX package and carried over with
``params_from_numpy``.  The JAX side's kernel route runs as
``attention_impl="pallas_interpret"``; the port's ``"pallas"`` route runs
the kernels' plain versions on the CPU.  Tolerance: 2e-4 (in-model parity).

The reference's eviction fault (ROADMAP.md, R2) is reproduced, not fixed:
after a prefill of s > window tokens with s % window != 0, the first decode
step overwrites the key of position s - window + s % window instead of the
oldest one, s - window.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as JC
from repro.models import decoding as JDEC
from repro.models import layers as JL
from repro.models import params as JP
from repro.models import transformer as JTF
from repro_torch.configs import base as TC
from repro_torch.kernels import ops as kops
from repro_torch.models import decoding as TDEC
from repro_torch.models import layers as TL
from repro_torch.models.params import params_from_numpy

import _torch_threads  # noqa: F401  (one intra-op thread per test worker)

TOL = dict(rtol=2e-4, atol=2e-4)  # in-model f32 parity
IMPLS = [("xla", "xla"), ("pallas_interpret", "pallas")]  # (JAX, port)
WINDOW = 16  # hymba-smoke's long_window
j_attn_forward = jax.jit(JL.attn_forward, static_argnames=("cfg", "window"))
j_attn_decode = jax.jit(JL.attn_decode, static_argnames=("cfg",))
j_prefill = jax.jit(JDEC.prefill, static_argnames=("cfg", "max_len", "window"))
j_decode_step = jax.jit(JDEC.decode_step, static_argnames=("cfg", "window"))


def _cfgs(arch="hymba-1.5b", jimpl="xla", timpl="xla", scan_impl="assoc", **kw):
    jcfg, tcfg = JC.get_smoke_config(arch, **kw), TC.get_smoke_config(arch, **kw)
    jcfg = dataclasses.replace(jcfg, attention_impl=jimpl)
    tcfg = dataclasses.replace(tcfg, attention_impl=timpl)
    if jcfg.ssm is not None:
        jcfg = dataclasses.replace(jcfg, ssm=dataclasses.replace(jcfg.ssm, scan_impl=scan_impl))
        tcfg = dataclasses.replace(tcfg, ssm=dataclasses.replace(tcfg.ssm, scan_impl=scan_impl))
    return jcfg, tcfg


def _carry(jtree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jtree), "cpu")


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.fixture
def calls(monkeypatch):
    """Calls of the K1 and K2 wrappers, counted (on the CPU a wrapper runs
    its plain version and does not count a launch), with K2's lengths."""
    counts = {"flash_attention": 0, "decode_attention": 0, "lengths": []}
    flash, decode = kops.flash_attention, kops.decode_attention

    def counted_flash(*args):
        counts["flash_attention"] += 1
        return flash(*args)

    def counted_decode(q, ck, cv, lengths):
        counts["decode_attention"] += 1
        counts["lengths"].append(lengths.tolist())
        return decode(q, ck, cv, lengths)

    monkeypatch.setattr(kops, "flash_attention", counted_flash)
    monkeypatch.setattr(kops, "decode_attention", counted_decode)
    return counts


# -- attention -----------------------------------------------------------------------


@pytest.mark.parametrize("s", [5, 12])  # within the window, past it
@pytest.mark.parametrize("jimpl,timpl", IMPLS)
def test_windowed_attn_forward_matches_jax(jimpl, timpl, s, calls):
    """A window of 5: the plain path on both routes, so no K1 call even
    where the sequence fits in the window (layers.py:204)."""
    jcfg, tcfg = _cfgs("gemma-2b", jimpl, timpl)
    jp = JP.init_params(jax.random.PRNGKey(0), JL.attention_defs(jcfg))
    x = np.random.default_rng(12).standard_normal((2, s, 64), np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s)).copy()
    want, (jk, jv) = j_attn_forward(jp, jnp.asarray(x), jnp.asarray(pos), cfg=jcfg, window=5)
    got, (tk, tv) = TL.attn_forward(_carry(jp), torch.from_numpy(x), torch.from_numpy(pos),
                                    tcfg, window=5)
    _close(got, want)
    _close(tk, jk)
    _close(tv, jv)
    assert calls["flash_attention"] == 0
    if s > 5:  # the window changes the output
        full, _ = TL.attn_forward(_carry(jp), torch.from_numpy(x), torch.from_numpy(pos), tcfg)
        assert not torch.allclose(full, got, **TOL)


@pytest.mark.parametrize("jimpl,timpl", IMPLS)
def test_attn_decode_writes_at_write_pos(jimpl, timpl, calls):
    """A circular buffer of 8 slots: the new K/V land at ``write_pos`` and
    ``min(pos + 1, M)`` slots are attended (K2 on the kernel route)."""
    jcfg, tcfg = _cfgs("granite-3-8b", jimpl, timpl, d_model=64, n_heads=4, n_kv_heads=2,
                       head_dim=16)
    jp = JP.init_params(jax.random.PRNGKey(0), JL.attention_defs(jcfg))
    rng = np.random.default_rng(13)
    x = rng.standard_normal((3, 1, 64), np.float32)
    ck = rng.standard_normal((3, 8, 2, 16), np.float32)
    cv = rng.standard_normal((3, 8, 2, 16), np.float32)
    pos = np.asarray([3, 8, 21], np.int32)
    wpos = pos % 8
    want, (jk, jv) = j_attn_decode(jp, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv),
                                   jnp.asarray(pos), cfg=jcfg, write_pos=jnp.asarray(wpos))
    got, (tk, tv) = TL.attn_decode(_carry(jp), torch.from_numpy(x), torch.from_numpy(ck.copy()),
                                   torch.from_numpy(cv.copy()), torch.from_numpy(pos), tcfg,
                                   write_pos=torch.from_numpy(wpos))
    _close(got, want)
    _close(tk, jk)
    _close(tv, jv)
    for row, slot in enumerate(wpos):  # every other slot is untouched
        keep = np.arange(8) != slot
        np.testing.assert_array_equal(_np(tk)[row][keep], ck[row][keep])
    if timpl == "pallas":
        assert calls["lengths"] == [[4, 8, 8]]


def test_blockwise_attention_is_not_ported():
    """The blockwise attention is ported now (tests/test_torch_blockwise.py);
    what the port still refuses, with or without a window, at prefill and at
    decode, is an ``attention_impl`` outside its list, the reference's
    ``pallas_interpret`` (a JAX interpret mode) among them."""
    x = torch.zeros(1, 4, 64)
    pos = torch.zeros(1, 4, dtype=torch.int32)
    for impl in ("pallas_interpret", "flash"):
        _, tcfg = _cfgs("gemma-2b", timpl=impl)
        p = {k: torch.zeros(v.shape) for k, v in TL.attention_defs(tcfg).items()}
        for window in (0, 2):
            with pytest.raises(NotImplementedError, match=f"attention_impl={impl!r}"):
                TL.attn_forward(p, x, pos, tcfg, window=window)
        cache = torch.zeros(1, 8, tcfg.n_kv_heads, tcfg.resolved_head_dim)
        with pytest.raises(NotImplementedError, match=f"attention_impl={impl!r}"):
            TL.attn_decode(p, x[:, :1], cache, cache.clone(), pos[:, 0], tcfg)


# -- hymba-smoke: prefill past the window, then decode past the wrap -----------------


def _model(jimpl, timpl, scan_impl):
    jcfg, tcfg = _cfgs("hymba-1.5b", jimpl, timpl, scan_impl)
    assert jcfg.long_window == tcfg.long_window == WINDOW
    jp = JP.init_params(jax.random.PRNGKey(3), JTF.model_defs(jcfg))
    return jcfg, tcfg, jp, _carry(jp)


def _check_cache(tc, jc):
    for key in ("k", "v", "conv", "ssm"):
        assert tuple(tc[key].shape) == jc[key].shape, key
        _close(tc[key], jc[key])
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


@pytest.mark.parametrize("s", [8, 16, 20, 32])  # s % window == 0 at 16, 32; R2 at 20
@pytest.mark.parametrize("scan_impl", ["assoc", "chunked"])
@pytest.mark.parametrize("jimpl,timpl", IMPLS)
def test_windowed_prefill_and_decode_match_jax(jimpl, timpl, scan_impl, s, calls):
    """Prefill of s tokens at B = 2 with window 16 into a cache of max_len 64
    (16 slots), then 20 decode steps, which wrap the buffer: logits and
    caches match the reference at every step; the kernel route calls no K1
    and one K2 a layer a step, with lengths min(pos + 1, 16)."""
    jcfg, tcfg, jp, tp = _model(jimpl, timpl, scan_impl)
    rng = np.random.default_rng(40 + s)
    toks = rng.integers(1, jcfg.vocab, size=(2, s)).astype(np.int32)
    jl, jc = j_prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, max_len=64, window=WINDOW)
    tl, tc = TDEC.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks).long()}, max_len=64,
                          window=WINDOW)
    assert tuple(tc["k"].shape)[2] == WINDOW
    _close(tl, jl)
    _check_cache(tc, jc)
    for step in range(20):
        nxt = rng.integers(1, jcfg.vocab, size=(2, 1)).astype(np.int32)
        jl, jc = j_decode_step(jp, jcfg, jc, jnp.asarray(nxt), window=WINDOW)
        tl, tc = TDEC.decode_step(tp, tcfg, tc, torch.from_numpy(nxt).long(), window=WINDOW)
        _close(tl, jl)
        _check_cache(tc, jc)
    assert calls["flash_attention"] == 0
    if timpl == "pallas":
        assert calls["decode_attention"] == 20 * tcfg.n_layers
        want = [[min(s + i + 1, WINDOW)] * 2 for i in range(20) for _ in range(tcfg.n_layers)]
        assert calls["lengths"] == want
    else:
        assert calls["decode_attention"] == 0


@pytest.mark.parametrize("s,evicted", [(16, 0), (20, 8), (32, 16)])
def test_first_step_evicts_as_the_reference_does(s, evicted):
    """R2: the prefill keeps positions s-16..s-1 in slots 0..15 and the first
    step writes slot s % 16.  At s % 16 == 0 that is the oldest key (position
    s - 16); at s = 20 it is position 8, while position 4, the oldest, stays."""
    jcfg, tcfg, jp, tp = _model("xla", "xla", "assoc")
    toks = np.random.default_rng(7).integers(1, jcfg.vocab, size=(1, s)).astype(np.int32)
    _, full = TDEC.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks).long()}, max_len=s)
    _, tc = TDEC.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks).long()}, max_len=64,
                         window=WINDOW)
    # layer 0's keys do not depend on the attention's window
    slots = tc["k"].clone()
    np.testing.assert_array_equal(slots[0].numpy(), full["k"][0, :, s - WINDOW:].numpy())
    _, tc = TDEC.decode_step(tp, tcfg, tc, torch.tensor([[1]]), window=WINDOW)
    written = (tc["k"] != slots).any(dim=(0, 1, 3, 4)).nonzero().flatten().tolist()
    assert written == [s % WINDOW]
    assert s - WINDOW + written[0] == evicted
    # the oldest key survives the first step only where s % 16 != 0
    oldest_kept = torch.equal(tc["k"][0, :, 0], full["k"][0, :, s - WINDOW])
    assert oldest_kept == (s % WINDOW != 0)
    _, jc = j_prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, max_len=64, window=WINDOW)
    _, jc = j_decode_step(jp, jcfg, jc, jnp.asarray([[1]], jnp.int32), window=WINDOW)
    _close(tc["k"], jc["k"])
