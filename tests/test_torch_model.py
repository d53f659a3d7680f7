"""The port's model modules against the JAX package, module by module and for
prefill + decode, on the gemma smoke config (2 layers, d=64) in f32, and
prefill + decode of the moe family's smoke configs.

Params are made by the JAX package and carried over with
``params_from_numpy``; other inputs are made with numpy from a seed.  The
JAX side's kernel route runs as ``attention_impl="pallas_interpret"``; the
port's ``"pallas"`` route runs the kernels' plain versions on the CPU.
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
from repro_torch.models import decoding as TDEC
from repro_torch.models import layers as TL
from repro_torch.models import params as TP
from repro_torch.models import transformer as TTF
from repro_torch.steps import init_model

import _torch_threads  # noqa: F401  (one intra-op thread per test worker)

TOL = dict(rtol=2e-4, atol=2e-4)  # in-model f32 parity
IMPLS = [("xla", "xla"), ("pallas_interpret", "pallas")]  # (JAX, port)
# jitted JAX entry points: one compile instead of op-by-op dispatch
j_attn_forward = jax.jit(JL.attn_forward, static_argnames=("cfg",))
j_attn_decode = jax.jit(JL.attn_decode, static_argnames=("cfg",))
j_prefill = jax.jit(JDEC.prefill, static_argnames=("cfg", "max_len"))
j_decode_step = jax.jit(JDEC.decode_step, static_argnames=("cfg",))
PORTED = [a for a in JC.ARCH_IDS if JC.get_config(a).family in TTF.PORTED_FAMILIES]


def _cfgs(arch="gemma-2b", **kw):
    return JC.get_smoke_config(arch, **kw), TC.get_smoke_config(arch, **kw)


def _carry(jparams):
    return TP.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


# -- per-module parity -----------------------------------------------------------


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm_matches_jax(kind):
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 5, 64), np.float32) * 3
    p = {"scale": rng.standard_normal(64).astype(np.float32),
         "bias": rng.standard_normal(64).astype(np.float32)}
    want = JL.apply_norm(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x), kind)
    got = TL.apply_norm({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x), kind)
    _close(got, want)


def test_rope_matches_jax():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 7, 3, 32), np.float32)
    pos = rng.integers(0, 4096, size=(2, 7)).astype(np.int32)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0)
    _close(got, want)


@pytest.mark.parametrize("jimpl,timpl", IMPLS)
def test_attn_forward_matches_jax(jimpl, timpl):
    jcfg, tcfg = _cfgs()
    jcfg = dataclasses.replace(jcfg, attention_impl=jimpl)
    tcfg = dataclasses.replace(tcfg, attention_impl=timpl)
    jp = JP.init_params(jax.random.PRNGKey(0), JL.attention_defs(jcfg))
    x = np.random.default_rng(12).standard_normal((2, 48, 64), np.float32)
    pos = np.broadcast_to(np.arange(48, dtype=np.int32), (2, 48))
    want, (jk, jv) = j_attn_forward(jp, jnp.asarray(x), jnp.asarray(pos), cfg=jcfg)
    got, (tk, tv) = TL.attn_forward(_carry(jp), torch.from_numpy(x),
                                    torch.from_numpy(pos.copy()), tcfg)
    _close(got, want)
    _close(tk, jk)
    _close(tv, jv)


@pytest.mark.parametrize("jimpl,timpl", IMPLS)
def test_attn_decode_matches_jax(jimpl, timpl):
    jcfg, tcfg = _cfgs("granite-3-8b", d_model=64, n_heads=4, n_kv_heads=2, head_dim=16)
    jcfg = dataclasses.replace(jcfg, attention_impl=jimpl)
    tcfg = dataclasses.replace(tcfg, attention_impl=timpl)
    jp = JP.init_params(jax.random.PRNGKey(0), JL.attention_defs(jcfg))
    rng = np.random.default_rng(13)
    x = rng.standard_normal((3, 1, 64), np.float32)
    ck = rng.standard_normal((3, 32, 2, 16), np.float32)
    cv = rng.standard_normal((3, 32, 2, 16), np.float32)
    pos = np.asarray([5, 31, 40], np.int32)  # 40 >= M: no write, all 32 slots valid
    want, (jk, jv) = j_attn_decode(jp, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv),
                                   jnp.asarray(pos), cfg=jcfg)
    got, (tk, tv) = TL.attn_decode(_carry(jp), torch.from_numpy(x), torch.from_numpy(ck.copy()),
                                   torch.from_numpy(cv.copy()), torch.from_numpy(pos), tcfg)
    _close(got, want)
    _close(tk, jk)
    _close(tv, jv)
    np.testing.assert_array_equal(_np(tk)[2], ck[2])  # pos >= M: slot rows untouched


@pytest.mark.parametrize("activation", ["geglu", "swiglu", "relu2", "gelu"])
def test_mlp_matches_jax(activation):
    jcfg, tcfg = _cfgs(activation=activation)
    jp = JP.init_params(jax.random.PRNGKey(1), JL.mlp_defs(jcfg))
    x = np.random.default_rng(14).standard_normal((2, 5, 64), np.float32)
    want = JL.apply_mlp(jp, jnp.asarray(x), activation)
    got = TL.apply_mlp(_carry(jp), torch.from_numpy(x), activation)
    _close(got, want)


@pytest.mark.parametrize("arch", ["gemma-2b", "granite-3-8b"])  # tied + scaled / untied
def test_embed_unembed_match_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    jp = JP.init_params(jax.random.PRNGKey(2), JL.embed_defs(jcfg))
    rng = np.random.default_rng(15)
    toks = rng.integers(0, jcfg.vocab, size=(2, 9)).astype(np.int32)
    x = rng.standard_normal((2, 9, 64), np.float32)
    tp = _carry(jp)
    _close(TL.embed_tokens(tp, torch.from_numpy(toks).long(), tcfg),
           JL.embed_tokens(jp, jnp.asarray(toks), jcfg))
    _close(TL.unembed(tp, torch.from_numpy(x), tcfg), JL.unembed(jp, jnp.asarray(x), jcfg))


def test_embed_scale_rounds_in_bf16_first():
    _, tcfg = _cfgs(dtype="bfloat16", d_model=2048)
    p = {"embedding": torch.ones(4, 2048, dtype=torch.bfloat16)}
    x = TL.embed_tokens(p, torch.tensor([[1]]), tcfg)
    assert x.dtype == torch.bfloat16 and float(x[0, 0, 0]) == 45.25


# -- prefill + decode --------------------------------------------------------------


def _model(arch="gemma-2b", jimpl="xla", timpl="xla", **kw):
    jcfg, tcfg = _cfgs(arch, **kw)
    jcfg = dataclasses.replace(jcfg, attention_impl=jimpl)
    tcfg = dataclasses.replace(tcfg, attention_impl=timpl)
    jp = JP.init_params(jax.random.PRNGKey(3), JTF.model_defs(jcfg))
    return jcfg, tcfg, jp, _carry(jp)


def _close_cache(tc, jc):
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def _check_prefill_and_decode(jcfg, tcfg, jp, tp, seed):
    """Prefill of 12 tokens, then 3 decode steps: logits and caches match."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, jcfg.vocab, size=(2, 12)).astype(np.int32)
    jl, jc = j_prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, max_len=16)
    tl, tc = TDEC.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks).long()}, max_len=16)
    assert tuple(tl.shape) == (2, 1, jcfg.vocab)
    _close(tl, jl)
    _close_cache(tc, jc)
    for _ in range(3):
        nxt = rng.integers(1, jcfg.vocab, size=(2, 1)).astype(np.int32)
        jl, jc = j_decode_step(jp, jcfg, jc, jnp.asarray(nxt))
        tl, tc = TDEC.decode_step(tp, tcfg, tc, torch.from_numpy(nxt).long())
        _close(tl, jl)
        _close_cache(tc, jc)


# gemma (dense), then the moe family: granite-moe (GQA, no shared expert) and
# moonshot (MHA, a shared expert); the gemma ids are the test's older ones
PREFILL_DECODE = [pytest.param(arch, jimpl, timpl, id=(f"{arch}-" if arch != "gemma-2b" else "")
                               + f"{jimpl}-{timpl}")
                  for arch in ("gemma-2b", "granite-moe-3b-a800m", "moonshot-v1-16b-a3b")
                  for jimpl, timpl in IMPLS]


@pytest.mark.parametrize("arch,jimpl,timpl", PREFILL_DECODE)
def test_prefill_and_decode_match_jax(arch, jimpl, timpl):
    _check_prefill_and_decode(*_model(arch, jimpl, timpl), seed=16)


@pytest.mark.parametrize("jimpl,timpl", IMPLS)
def test_prefill_and_decode_match_jax_at_head_dim_96(jimpl, timpl):
    """phi3-mini's head dim (96) on a narrow MHA model: 2 layers, d_model
    192, 2 heads; the kernels' contract takes it (D = 96 and 192 are in
    ``HEAD_DIMS``)."""
    jcfg, tcfg, jp, tp = _model("phi3-mini-3.8b", jimpl, timpl, d_model=192, n_heads=2,
                                n_kv_heads=2, head_dim=96)
    assert tcfg.n_layers == 2 and tcfg.resolved_head_dim == 96
    _check_prefill_and_decode(jcfg, tcfg, jp, tp, seed=18)


@pytest.mark.parametrize("arch", ["gemma-2b", "hymba-1.5b"])
def test_unrolled_layers_match_jax(arch):
    """``layer_impl="unroll"``: ``blocks`` is a list of per-layer params in
    both packages; prefill, decode and the training loss match."""
    jcfg, tcfg, jp, tp = _model(arch, layer_impl="unroll")
    assert isinstance(jp["blocks"], list) and isinstance(tp["blocks"], list)
    _check_prefill_and_decode(jcfg, tcfg, jp, tp, seed=19)
    rng = np.random.default_rng(19)
    batch = {"tokens": rng.integers(0, jcfg.vocab, (2, 12)).astype(np.int32),
             "targets": rng.integers(0, jcfg.vocab, (2, 12)).astype(np.int32),
             "mask": np.ones((2, 12), np.float32)}
    want, _ = JTF.forward_train(jp, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    got, _ = TTF.forward_train(tp, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_prefill_truncates_to_the_cache_when_the_prompt_fills_it():
    jcfg, tcfg, jp, tp = _model()
    toks = np.random.default_rng(17).integers(1, jcfg.vocab, size=(1, 20)).astype(np.int32)
    jl, jc = j_prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, max_len=16)
    tl, tc = TDEC.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks).long()}, max_len=16)
    _close(tl, jl)
    _close_cache(tc, jc)


# -- params and defs ---------------------------------------------------------------


def _def_table(defs):
    """{path: (shape, dtype name, axes, init, scale)} for both packages' defs."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, path + (i,))
        else:
            dt = str(t.dtype).replace("torch.", "") if isinstance(t.dtype, torch.dtype) \
                else np.dtype(t.dtype).name
            out[path] = (tuple(t.shape), dt, tuple(t.axes), t.init, t.scale)

    walk(defs, ())
    return out


@pytest.mark.parametrize("arch", PORTED)
def test_model_defs_match_jax_at_full_width(arch):
    want = _def_table(JTF.model_defs(JC.get_config(arch), max_seq=128))
    got = _def_table(TTF.model_defs(TC.get_config(arch), max_seq=128))
    assert got == want


@pytest.mark.parametrize("arch", ["gemma-2b", "xlstm-125m"])
def test_unported_families_raise(arch):
    """Every family of the reference is ported; a config of any other family
    raises, naming it."""
    assert set(TTF.PORTED_FAMILIES) == {JC.get_config(a).family for a in JC.ARCH_IDS}
    cfg = dataclasses.replace(TC.get_smoke_config(arch), family="retnet")
    with pytest.raises(NotImplementedError, match="retnet"):
        TTF.model_defs(cfg)


def test_init_params_match_jax_structure():
    """Dense (gemma), hybrid (hymba, whose SSM leaves take the "scaled"
    uniform init), moe (granite-moe: stacked experts, an f32 router), vlm
    (phi-3-vision: img_proj) and encdec (whisper: encoder and decoder
    stacks, position tables) smoke models."""
    for arch in ("gemma-2b", "hymba-1.5b", "granite-moe-3b-a800m", "phi-3-vision-4.2b",
                 "whisper-large-v3"):
        jcfg, tcfg = _cfgs(arch)
        jp = JP.init_params(jax.random.PRNGKey(0), JTF.model_defs(jcfg))
        defs = TTF.model_defs(tcfg)
        tp = TP.init_params(defs, torch.Generator().manual_seed(0))
        jflat = {jax.tree_util.keystr(k): v
                 for k, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
        tflat = {}
        for path, d in _def_table(defs).items():
            t = tp
            for k in path:
                t = t[k]
            tflat["".join(f"[{k!r}]" for k in path)] = (t, d)
        assert set(tflat) == set(jflat)
        inits = set()
        for key, (t, (shape, dt, _, init, scale)) in tflat.items():
            inits.add(init)
            assert tuple(t.shape) == jflat[key].shape == shape
            assert str(t.dtype).replace("torch.", "") == jflat[key].dtype.name == dt
            if init == "ones":
                assert bool((t == 1).all())
            elif init == "zeros":
                assert not bool(t.any())
            elif init in ("normal", "embed"):
                std = scale if init == "embed" else scale / np.sqrt(shape[-2])
                assert float(t.abs().max()) <= 2 * std * (1 + 1e-6)
                assert 0.5 * std < float(t.float().std()) < std
            elif init == "scaled":  # uniform in +-scale: std scale / sqrt(3)
                assert float(t.abs().max()) <= scale
                assert 0.8 * scale / np.sqrt(3) < float(t.float().std()) < 1.2 * scale / np.sqrt(3)
            else:
                raise AssertionError(f"{key}: init {init!r} not checked")
        if arch == "hymba-1.5b":
            assert "scaled" in inits


def test_params_from_numpy_keeps_bf16_bits():
    jcfg, _ = _cfgs(dtype="bfloat16")
    jp = JP.init_params(jax.random.PRNGKey(4), JL.attention_defs(jcfg))
    tp = _carry(jp)
    for k in jp:
        assert tp[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(tp[k].view(torch.int16).numpy().view(np.uint16),
                                      np.asarray(jp[k]).view(np.uint16))
    assert TP.param_bytes(TL.attention_defs(TC.get_smoke_config(
        "gemma-2b", dtype="bfloat16"))) == JP.param_bytes(JL.attention_defs(jcfg))


def test_moe_params_keep_an_f32_router_in_a_bf16_model():
    """A bf16 moe model's router stays f32, whether drawn by ``init_model``
    or carried from the JAX package's params (bits kept); the stacked experts
    are (L, E, d, f) and each layer's are a view of its row."""
    jcfg, tcfg = _cfgs("granite-moe-3b-a800m", dtype="bfloat16")
    jp = JP.init_params(jax.random.PRNGKey(5), JTF.model_defs(jcfg))
    carried = _carry(jp)
    _, drawn = init_model(tcfg, seed=0, device="cpu")
    m = tcfg.moe
    for tp in (carried, drawn):
        moe = tp["blocks"]["moe"]
        assert moe["router"].dtype == torch.float32
        assert {moe[k].dtype for k in ("w1", "w2", "w3")} == {torch.bfloat16}
        assert tuple(moe["w1"].shape) == (tcfg.n_layers, m.e_pad, tcfg.d_model, m.d_ff_expert)
        layer = TTF.layer_params(tp["blocks"], 1)["moe"]
        assert layer["w2"].data_ptr() == moe["w2"][1].data_ptr()
    np.testing.assert_array_equal(carried["blocks"]["moe"]["router"].numpy(),
                                  np.asarray(jp["blocks"]["moe"]["router"]))
    np.testing.assert_array_equal(
        carried["blocks"]["moe"]["w1"].view(torch.int16).numpy().view(np.uint16),
        np.asarray(jp["blocks"]["moe"]["w1"]).view(np.uint16))
