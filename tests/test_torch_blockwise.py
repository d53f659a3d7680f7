"""The port's blockwise attention (``attention_impl`` ``"blockwise"`` and
``"blockwise_u"``) against the JAX package's, on the CPU at smoke size in
f32: ``attn_forward`` with q in chunks of 8 (S a multiple of the chunk and
not, with and without a window), a hymba-smoke prefill and 4 decode steps
(decode takes the plain path, as in the reference), and ``forward_train``'s
loss and every grad.  The embedding scale made on the device is held to the
reference's too.

Params are made by the JAX package and carried over with
``params_from_numpy``; other inputs are made with numpy from a seed.
Tolerances: attention alone, max |error| within 2e-5 of max |want| (the
reference's f32 kernel tolerance; the scores run in the tens, so an
element's error follows the row's scale, not its own); in-model, 2e-4
element by element (``tests/test_torch_window.py``).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import steps as JS
from repro.configs import base as JC
from repro.models import decoding as JDEC
from repro.models import layers as JL
from repro.models import params as JP
from repro.models import transformer as JTF
from repro.models import xlstm as JXL
from repro_torch.configs import base as TC
from repro_torch.kernels import ops as kops
from repro_torch.models import decoding as TDEC
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TTF
from repro_torch.models import xlstm as TXL
from repro_torch.models.params import params_from_numpy, tree_leaves, tree_map, tree_paths

import _torch_threads  # noqa: F401  (one intra-op thread per test worker)

ATTN_TOL = 2e-5  # of max |want|
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)
BLOCK_Q = 8
IMPLS = ["blockwise", "blockwise_u"]
j_attn_forward = jax.jit(JL.attn_forward, static_argnames=("cfg", "window"))
j_prefill = jax.jit(JDEC.prefill, static_argnames=("cfg", "max_len", "window"))
j_decode_step = jax.jit(JDEC.decode_step, static_argnames=("cfg", "window"))


def _cfgs(arch, impl, **kw):
    return (JC.get_smoke_config(arch, attention_impl=impl, attention_block_q=BLOCK_Q, **kw),
            TC.get_smoke_config(arch, attention_impl=impl, attention_block_q=BLOCK_Q, **kw))


def _carry(jtree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jtree), "cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _close_rel(got, want, tol=ATTN_TOL):
    """max |got - want| <= tol * max |want|."""
    g, w = _np(got), _np(want)
    assert g.shape == w.shape
    err, top = float(np.abs(g - w).max()), float(np.abs(w).max())
    assert err <= tol * top, f"max err {err:.3e} > {tol} x max |want| {top:.3e}"


# -- attention ------------------------------------------------------------------------


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("s", [24, 21])  # three chunks of 8; 21 pads the last with 3
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ["gemma-2b", "hymba-1.5b"])  # MQA 4/1, GQA 4/2
def test_blockwise_attn_forward_matches_jax(arch, impl, s, window):
    jcfg, tcfg = _cfgs(arch, impl)
    assert s > BLOCK_Q
    jp = JP.init_params(jax.random.PRNGKey(0), JL.attention_defs(jcfg))
    x = np.random.default_rng(21).standard_normal((2, s, jcfg.d_model), np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s)).copy()
    want, (jk, jv) = j_attn_forward(jp, jnp.asarray(x), jnp.asarray(pos), cfg=jcfg, window=window)
    tp = _carry(jp)
    got, (tk, tv) = TL.attn_forward(tp, torch.from_numpy(x), torch.from_numpy(pos), tcfg,
                                    window=window)
    _close_rel(got, want)
    _close_rel(tk, jk)
    _close_rel(tv, jv)
    # the plain route computes the same (the chunks change nothing)
    plain, _ = TL.attn_forward(tp, torch.from_numpy(x), torch.from_numpy(pos),
                               dataclasses.replace(tcfg, attention_impl="xla"), window=window)
    _close_rel(got, plain)


def test_blockwise_takes_no_kernel_and_leaves_cross_attention_plain(monkeypatch):
    """K1 is never called under blockwise; a bidirectional (encoder) call
    takes the plain path, as in the reference (layers.py:213)."""
    def refuse(*_):
        raise AssertionError("K1 called")

    monkeypatch.setattr(kops, "flash_attention", refuse)
    jcfg, tcfg = _cfgs("whisper-large-v3", "blockwise")
    jp = JP.init_params(jax.random.PRNGKey(1), JL.attention_defs(jcfg))
    x = np.random.default_rng(22).standard_normal((2, 12, jcfg.d_model), np.float32)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12)).copy()
    want, _ = JL.attn_forward(jp, jnp.asarray(x), jnp.asarray(pos), jcfg, causal=False)
    got, _ = TL.attn_forward(_carry(jp), torch.from_numpy(x), torch.from_numpy(pos), tcfg,
                             causal=False)
    _close_rel(got, want)


# -- hymba-smoke: prefill, then decode on the plain path -------------------------------


@pytest.mark.parametrize("scan_impl", ["assoc", "chunked"])
@pytest.mark.parametrize("window", [0, 16])  # 16 = hymba-smoke's long_window
def test_blockwise_prefill_and_decode_match_jax(window, scan_impl):
    """B = 2, a 20-token prompt (past the window of 16, and three chunks, the
    last padded), a cache of 32, then 4 decode steps: logits and every cache
    leaf within 2e-4."""
    jcfg, tcfg = _cfgs("hymba-1.5b", "blockwise")
    jcfg = dataclasses.replace(jcfg, ssm=dataclasses.replace(jcfg.ssm, scan_impl=scan_impl))
    tcfg = dataclasses.replace(tcfg, ssm=dataclasses.replace(tcfg.ssm, scan_impl=scan_impl))
    assert tcfg.long_window == 16
    _, jp = JS.init_model(jcfg, seed=3, max_seq=32)
    tp = _carry(jp)
    rng = np.random.default_rng(23)
    tokens = rng.integers(0, jcfg.vocab, (2, 20)).astype(np.int32)
    steps = rng.integers(0, jcfg.vocab, (4, 2, 1)).astype(np.int32)
    jl, jc = j_prefill(jp, jcfg, {"tokens": jnp.asarray(tokens)}, max_len=32, window=window)
    with torch.no_grad():
        tl, tc = TDEC.prefill(tp, tcfg, {"tokens": torch.from_numpy(tokens)}, max_len=32,
                              window=window)
        for i in range(5):
            _close(tl, jl, MODEL_TOL)
            for key in ("k", "v", "conv", "ssm"):
                assert tuple(tc[key].shape) == jc[key].shape, key
                _close(tc[key], jc[key], MODEL_TOL)
            np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
            if i == 4:
                break
            jl, jc = j_decode_step(jp, jcfg, jc, jnp.asarray(steps[i]), window=window)
            tl, tc = TDEC.decode_step(tp, tcfg, tc, torch.from_numpy(steps[i]), window=window)


# -- training -------------------------------------------------------------------------


def _tame(jp, jcfg):
    """wq and wk rescaled to std 1/sqrt(d_model), so the scores are O(1) and
    the grads of two correct implementations agree (tests/test_torch_train.py)."""
    attn = dict(jp["blocks"]["attn"])
    for name, heads in (("wq", jcfg.n_heads), ("wk", jcfg.n_kv_heads)):
        attn[name] = attn[name] * np.sqrt(heads / jcfg.d_model)
    return dict(jp, blocks=dict(jp["blocks"], attn=attn))


@pytest.mark.parametrize("window", [0, 6])
@pytest.mark.parametrize("arch", ["gemma-2b", "hymba-1.5b"])
def test_blockwise_forward_train_matches_jax(arch, window):
    """The loss and every grad leaf against ``jax.value_and_grad`` of the
    reference's ``forward_train`` under blockwise, 20 tokens (three chunks,
    the last padded), with and without a window of 6."""
    jcfg, tcfg = _cfgs(arch, "blockwise")
    _, jp = JS.init_model(jcfg, seed=0, max_seq=20)
    jp = _tame(jp, jcfg)
    tp = _carry(jp)
    rng = np.random.default_rng(24)
    batch = {"tokens": rng.integers(0, jcfg.vocab, (2, 20)).astype(np.int32),
             "targets": rng.integers(0, jcfg.vocab, (2, 20)).astype(np.int32),
             "mask": np.ones((2, 20), np.float32)}
    (jtotal, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: JTF.forward_train(p, jcfg, b, window=window, remat=False),
        has_aux=True))(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tree_map(lambda t: t.requires_grad_(True), tp)
    ttotal, tm = TTF.forward_train(tp, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()},
                                   window=window, remat=True)
    ttotal.backward()
    assert abs(float(ttotal.detach()) - float(jtotal)) <= 1e-5 * abs(float(jtotal))
    jpaths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(jgrads)[0]]
    assert [p for p, _ in tree_paths(tp)] == jpaths
    for path, t, g in zip(jpaths, tree_leaves(tp), jax.tree_util.tree_leaves(jgrads)):
        g = np.asarray(g, np.float32)
        err = float(np.abs(t.grad.numpy() - g).max())
        assert err <= 2e-4 * float(np.abs(g).max()), f"{path}: {err:.3e}"


# -- scalars made on the device ----------------------------------------------------------


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_embedding_scale_made_on_the_device_matches_jax(dtype):
    """gemma's sqrt(d_model) is cast to the activation dtype before the
    multiply (45.25 for 2048 in bf16) and made with ``torch.full`` on the
    tokens' device, which reads nothing from the host."""
    jcfg = JC.get_config("gemma-2b", dtype=dtype)
    tcfg = TC.get_config("gemma-2b", dtype=dtype)
    emb = np.eye(8, jcfg.d_model, dtype=np.float32)
    tokens = np.arange(8, dtype=np.int32)[None]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = JL.embed_tokens({"embedding": jnp.asarray(emb, jdt)}, jnp.asarray(tokens), jcfg)
    got = TL.embed_tokens(params_from_numpy({"embedding": np.asarray(jnp.asarray(emb, jdt))},
                                            "cpu"), torch.from_numpy(tokens), tcfg)
    np.testing.assert_array_equal(_np(got), _np(want))
    if dtype == "bfloat16":
        assert float(got[0, 0, 0]) == 45.25 != math.sqrt(2048)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_mlstm_key_scale_made_on_the_device_matches_jax(dtype):
    """The mLSTM divides k by sqrt(dh) cast to the activation dtype (19.625
    in bf16 at dh = 384): the port makes it on the device."""
    jcfg = JC.get_smoke_config("xlstm-125m", dtype=dtype)
    tcfg = TC.get_smoke_config("xlstm-125m", dtype=dtype)
    jp = JP.init_params(jax.random.PRNGKey(5), JXL.mlstm_defs(jcfg))
    x = jnp.asarray(np.random.default_rng(25).standard_normal((2, 6, jcfg.d_model)),
                    jnp.dtype(dtype))
    want = JXL._mlstm_qkvgates(jp, x, jcfg)[1]
    got = TXL._mlstm_qkvgates(_carry(jp), params_from_numpy(np.asarray(x), "cpu"), tcfg)[1]
    _close_rel(got, want, ATTN_TOL if dtype == "float32" else 2e-2)
