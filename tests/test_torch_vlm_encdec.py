"""The port's vlm (phi-3-vision) and encdec (whisper) families against the
JAX package, on their smoke configs in f32: the attention variants they add
(bidirectional, cross over a 3-D or 4-D source, cross decode), the defs at
full width, prefill + decode with every cache leaf, the training forward,
its grads and one AdamW step, the stub frontend, the train launcher, and the
engine's and serve launcher's refusal of both families.

Params are made by the JAX package and carried over with
``params_from_numpy``; other inputs are made with numpy from a seed.  The
JAX side's kernel route runs as ``attention_impl="pallas_interpret"``; the
port's ``"pallas"`` route runs the kernels' plain versions on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import steps as JS
from repro.configs import base as JC
from repro.data import pipeline as JD
from repro.models import decoding as JDEC
from repro.models import layers as JL
from repro.models import params as JP
from repro.models import transformer as JTF
from repro.optim import adamw as JA
from repro_torch.configs import base as TC
from repro_torch.data import pipeline as TD
from repro_torch.kernels import ops as kops
from repro_torch.launch import serve
from repro_torch.launch import train as TT
from repro_torch.models import decoding as TDEC
from repro_torch.models import layers as TL
from repro_torch.models import params as TP
from repro_torch.models import transformer as TTF
from repro_torch.optim import adamw as TA
from repro_torch.serving import ServingEngine
from repro_torch.steps import init_model, make_train_step

import _torch_threads  # noqa: F401  (one intra-op thread per test worker)

TOL = dict(rtol=2e-4, atol=2e-4)  # in-model f32 parity
IMPLS = [("xla", "xla"), ("pallas_interpret", "pallas")]  # (JAX, port)
ARCHS = ["phi-3-vision-4.2b", "whisper-large-v3"]
OPT = dict(lr=1e-2, warmup_steps=1, total_steps=10)
j_attn_forward = jax.jit(JL.attn_forward, static_argnames=("cfg", "causal"))
j_attn_decode = jax.jit(JL.attn_decode, static_argnames=("cfg", "cross"))
j_prefill = jax.jit(JDEC.prefill, static_argnames=("cfg", "max_len"))
j_decode_step = jax.jit(JDEC.decode_step, static_argnames=("cfg",))


def _cfgs(arch, jimpl="xla", timpl="xla", **kw):
    return (JC.get_smoke_config(arch, attention_impl=jimpl, **kw),
            TC.get_smoke_config(arch, attention_impl=timpl, **kw))


def _carry(jtree):
    return TP.params_from_numpy(jax.tree_util.tree_map(np.asarray, jtree), "cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _close_leaf(got, want, what, tol=2e-4):
    """max |got - want| <= tol * max |want|."""
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    err, top = float(np.abs(g - w).max()), float(np.abs(w).max())
    assert err <= tol * top, f"{what}: max err {err:.3e} > {tol} x max |x| {top:.3e}"


def _close_trees(got, want):
    jpaths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(want)[0]]
    assert [p for p, _ in TP.tree_paths(got)] == jpaths
    for (path, g), w in zip(TP.tree_paths(got), jax.tree_util.tree_leaves(want)):
        _close_leaf(g, w, path)


def _model(arch, jimpl="xla", timpl="xla", max_seq=32, tame=False, seed=3):
    jcfg, tcfg = _cfgs(arch, jimpl, timpl)
    _, jp = JS.init_model(jcfg, seed=seed, max_seq=max_seq)
    if tame:
        jp = _tame(jp, jcfg)
    return jcfg, tcfg, jp, _carry(jp)


def _tame(jp, jcfg):
    """wq and wk of every attention module rescaled to std 1/sqrt(d_model),
    so the scores are O(1) and the f32 grads of two right implementations
    agree (the reference draws wk at std 1: scores in the hundreds, whose
    softmax backward cancels; see tests/test_torch_train.py)."""
    def tamed(attn):
        attn = dict(attn)
        for name, heads in (("wq", jcfg.n_heads), ("wk", jcfg.n_kv_heads)):
            w = attn[name]
            attn[name] = (w.astype(jnp.float32) * np.sqrt(heads / jcfg.d_model)).astype(w.dtype)
        return attn

    out = dict(jp)
    for stack, mods in (("blocks", ("attn", "cross")), ("enc_blocks", ("attn",))):
        if stack in jp:
            out[stack] = dict(jp[stack], **{m: tamed(jp[stack][m]) for m in mods
                                            if m in jp[stack]})
    return out


def _inputs(jcfg, b=2, s=12, seed=16):
    """tokens, targets and mask from a seed, with the reference's stubs."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(1, jcfg.vocab, size=(b, s)).astype(np.int32),
             "targets": rng.integers(0, jcfg.vocab, size=(b, s)).astype(np.int32),
             "mask": np.ones((b, s), np.float32)}
    batch["mask"][:, : s // 3] = 0.0
    return JD.with_frontend_stubs(batch, jcfg, seed=seed)


def _jb(batch, keys=None):
    return {k: jnp.asarray(v) for k, v in batch.items() if keys is None or k in keys}


def _tb(batch, keys=None):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items() if keys is None or k in keys}


SERVE_KEYS = ("tokens", "img_embeds", "enc_frames")


@pytest.fixture
def calls(monkeypatch):
    """Calls of the K1 and K2 wrappers, counted (on the CPU a wrapper runs
    its plain version and does not count a launch)."""
    counts = dict.fromkeys(("flash_attention", "decode_attention"), 0)
    for name in counts:
        def counted(*args, _fn=getattr(kops, name), _name=name):
            counts[_name] += 1
            return _fn(*args)
        monkeypatch.setattr(kops, name, counted)
    return counts


# -- attention: bidirectional, cross, cross decode ------------------------------------


@pytest.mark.parametrize("mode", ["bidirectional", "cross_3d", "cross_4d"])
@pytest.mark.parametrize("jimpl,timpl", IMPLS)
def test_attn_forward_variants_match_jax(mode, jimpl, timpl, calls):
    """``causal=False`` and ``kv_override`` take the plain path on both
    routes (the reference's gate, layers.py:204): no K1 call."""
    jcfg, tcfg = _cfgs("whisper-large-v3", jimpl, timpl, rope_theta=10_000.0)
    jp = JP.init_params(jax.random.PRNGKey(0), JL.attention_defs(jcfg))
    rng = np.random.default_rng(30)
    x = rng.standard_normal((2, 9, 64), np.float32)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9)).copy()
    kw, tkw = {}, {}
    if mode == "bidirectional":
        kw = tkw = dict(causal=False)
    else:
        shape = (2, 13, 64) if mode == "cross_3d" else (2, 13, 4, 16)
        src_k = rng.standard_normal(shape, np.float32)
        src_v = rng.standard_normal(shape, np.float32)
        kw = dict(kv_override=(jnp.asarray(src_k), jnp.asarray(src_v)))
        tkw = dict(kv_override=(torch.from_numpy(src_k), torch.from_numpy(src_v)))
    want, (jk, jv) = j_attn_forward(jp, jnp.asarray(x), jnp.asarray(pos), cfg=jcfg, **kw)
    got, (tk, tv) = TL.attn_forward(_carry(jp), torch.from_numpy(x), torch.from_numpy(pos),
                                    tcfg, **tkw)
    assert calls["flash_attention"] == 0
    _close(got, want)
    _close(tk, jk)
    _close(tv, jv)
    if mode == "cross_4d":  # a 4-D source is the K/V as it is
        assert torch.equal(tk, tkw["kv_override"][0])


@pytest.mark.parametrize("jimpl,timpl", IMPLS)
def test_cross_attn_decode_matches_jax(jimpl, timpl, calls):
    """``cross=True`` writes nothing, attends every slot, uses no rope and
    takes the plain path on both routes (layers.py:271): no K2 call."""
    jcfg, tcfg = _cfgs("whisper-large-v3", jimpl, timpl, rope_theta=10_000.0)
    jp = JP.init_params(jax.random.PRNGKey(0), JL.cross_attention_defs(jcfg))
    rng = np.random.default_rng(31)
    x = rng.standard_normal((3, 1, 64), np.float32)
    ck = rng.standard_normal((3, 16, 4, 16), np.float32)
    cv = rng.standard_normal((3, 16, 4, 16), np.float32)
    pos = np.asarray([0, 5, 40], np.int32)
    want, _ = j_attn_decode(jp, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv),
                            jnp.asarray(pos), cfg=jcfg, cross=True)
    tck, tcv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    got, (gk, gv) = TL.attn_decode(_carry(jp), torch.from_numpy(x), tck, tcv,
                                   torch.from_numpy(pos), tcfg, cross=True)
    assert calls["decode_attention"] == 0
    _close(got, want)
    assert gk is tck and gv is tcv
    np.testing.assert_array_equal(tck.numpy(), ck)
    np.testing.assert_array_equal(tcv.numpy(), cv)


# -- defs and params -----------------------------------------------------------------


@pytest.mark.parametrize("arch,params_b", [("phi-3-vision-4.2b", 3.831),
                                           ("whisper-large-v3", 1.604)])
def test_model_defs_match_jax_at_full_width(arch, params_b):
    """Whisper's decoder position table has max_seq = 448 rows (its text
    context), its encoder's enc_frames = 1500; phi-3-vision adds img_proj.
    (``ModelConfig.n_params`` leaves img_proj and the position tables out:
    3.821 and 1.601 B.)"""
    jdefs = JTF.model_defs(JC.get_config(arch), max_seq=448)
    tdefs = TTF.model_defs(TC.get_config(arch), max_seq=448)
    jflat = {jax.tree_util.keystr(p): (d.shape, np.dtype(d.dtype).name, d.axes, d.init, d.scale)
             for p, d in jax.tree_util.tree_flatten_with_path(
                 jdefs, is_leaf=JP.is_paramdef)[0]}
    tflat = {p: (d.shape, str(d.dtype).replace("torch.", ""), d.axes, d.init, d.scale)
             for p, d in TP.tree_paths(tdefs)}
    assert tflat == jflat
    assert TP.count_params(tdefs) == JP.count_params(jdefs)
    assert round(TP.count_params(tdefs) / 1e9, 3) == params_b
    if arch == "whisper-large-v3":
        assert tdefs["dec_pos"]["pos"].shape == (448, 1280)
        assert tdefs["enc_pos"]["pos"].shape == (1500, 1280)
        assert tdefs["enc_blocks"]["attn"]["wq"].shape == (32, 1280, 20, 64)
    else:
        assert tdefs["img_proj"]["w"].shape == (3072, 3072)


@pytest.mark.parametrize("max_seq,rows", [(40, 40), (3, 8)])
def test_init_model_sizes_the_decoder_position_table(max_seq, rows):
    """``init_model`` passes ``max_seq`` on: max(max_seq, 8) rows, as the
    reference's ``model_defs``."""
    _, tcfg = _cfgs("whisper-large-v3")
    _, params = init_model(tcfg, max_seq=max_seq, device="cpu")
    assert tuple(params["dec_pos"]["pos"].shape) == (rows, 64)
    assert tuple(params["enc_pos"]["pos"].shape) == (tcfg.enc_frames, 64)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_numpy_carries_the_tree(arch):
    """The encdec tree (encoder and decoder stacks, position tables) and
    vlm's img_proj cross over leaf for leaf, bits kept, in bf16 too."""
    jcfg = JC.get_smoke_config(arch, dtype="bfloat16")
    _, jp = JS.init_model(jcfg, seed=5, max_seq=24)
    tp = _carry(jp)
    jleaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert [p for p, _ in TP.tree_paths(tp)] == [jax.tree_util.keystr(p) for p, _ in jleaves]
    for (path, t), (_, j) in zip(TP.tree_paths(tp), jleaves):
        j = np.asarray(j)
        assert tuple(t.shape) == j.shape, path
        if t.dtype == torch.bfloat16:
            np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16),
                                          j.view(np.uint16))
        else:
            np.testing.assert_array_equal(t.numpy(), j)
    assert ("img_proj" in tp) == (arch == "phi-3-vision-4.2b")
    assert ("enc_blocks" in tp) == (arch == "whisper-large-v3")


# -- prefill + decode ------------------------------------------------------------------


def _close_cache(tc, jc):
    assert set(tc) == set(jc)
    for key in jc:
        if key == "pos":
            np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
        else:
            _close(tc[key], jc[key])


@pytest.mark.parametrize("jimpl,timpl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch, jimpl, timpl, calls):
    """Prefill of 12 tokens (after 8 stub image rows for phi-3-vision, over
    16 stub frames for whisper), then 3 decode steps: the logits and every
    cache leaf, whisper's cross_k and cross_v included.  On the kernel
    route K1 and K2 are called once a decoder layer, never for whisper's
    encoder or cross-attention."""
    jcfg, tcfg, jp, tp = _model(arch, jimpl, timpl)
    batch = _inputs(jcfg)
    jl, jc = j_prefill(jp, jcfg, _jb(batch, SERVE_KEYS), max_len=32)
    tl, tc = TDEC.prefill(tp, tcfg, _tb(batch, SERVE_KEYS), max_len=32)
    assert tuple(tl.shape) == (2, 1, jcfg.vocab)
    _close(tl, jl)
    _close_cache(tc, jc)
    rng = np.random.default_rng(17)
    for _ in range(3):
        nxt = rng.integers(1, jcfg.vocab, size=(2, 1)).astype(np.int32)
        jl, jc = j_decode_step(jp, jcfg, jc, jnp.asarray(nxt))
        tl, tc = TDEC.decode_step(tp, tcfg, tc, torch.from_numpy(nxt).long())
        _close(tl, jl)
        _close_cache(tc, jc)
    per_layer = tcfg.n_layers if timpl == "pallas" else 0
    assert calls == {"flash_attention": per_layer, "decode_attention": 3 * per_layer}


@pytest.mark.parametrize("jimpl,timpl", IMPLS)
def test_whisper_decode_keeps_the_reference_position_quirk(jimpl, timpl):
    """The reference's decode_step adds no dec_pos (repro/models/decoding.py:207;
    only its prefill adds it, :160), so prefill(8) + decode(9th token)
    differs from prefill(9).  The port computes the same function: its
    decode equals JAX's, and the gap between the two paths is JAX's gap."""
    jcfg, tcfg, jp, tp = _model("whisper-large-v3", jimpl, timpl)
    batch = _inputs(jcfg, s=9)
    keys = ("enc_frames",)
    j9, _ = j_prefill(jp, jcfg, dict(_jb(batch, keys), tokens=jnp.asarray(batch["tokens"])),
                      max_len=16)
    _, jc = j_prefill(jp, jcfg, dict(_jb(batch, keys), tokens=jnp.asarray(batch["tokens"][:, :8])),
                      max_len=16)
    j8, _ = j_decode_step(jp, jcfg, jc, jnp.asarray(batch["tokens"][:, 8:]))
    t9, _ = TDEC.prefill(tp, tcfg, dict(_tb(batch, keys),
                                        tokens=torch.from_numpy(batch["tokens"]).long()), 16)
    _, tc = TDEC.prefill(tp, tcfg, dict(_tb(batch, keys),
                                        tokens=torch.from_numpy(batch["tokens"][:, :8]).long()), 16)
    t8, _ = TDEC.decode_step(tp, tcfg, tc, torch.from_numpy(batch["tokens"][:, 8:]).long())
    _close(t9, j9)
    _close(t8, j8)
    gap = float(np.abs(np.asarray(j9) - np.asarray(j8)).max())
    assert gap > 1e-2 * float(np.abs(np.asarray(j9)).max())  # the quirk is there
    np.testing.assert_allclose(float(np.abs(_np(t9) - _np(t8)).max()), gap, rtol=1e-3)


def test_encdec_prefill_refuses_a_prompt_longer_than_the_cache():
    """The reference does not truncate an encdec prompt to the cache (its
    dense path does); the port raises."""
    jcfg, tcfg, _, tp = _model("whisper-large-v3")
    batch = _inputs(jcfg, s=20)
    with pytest.raises(ValueError, match="longer than max_len=16"):
        TDEC.prefill(tp, tcfg, _tb(batch, SERVE_KEYS), max_len=16)


# -- training --------------------------------------------------------------------------


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_loss_and_grads_match_jax(arch, remat):
    """vlm strips its image rows before the unembedding; encdec's encoder
    runs once, outside remat, and its grads come back through every
    decoder layer's cross-attention."""
    jcfg, tcfg, jp, tp = _model(arch, max_seq=16, tame=True)
    batch = _inputs(jcfg, seed=18)

    def loss_fn(p):
        return JTF.forward_train(p, jcfg, _jb(batch), remat=remat)

    (jtotal, jm), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(jp)
    TP.tree_map(lambda t: t.requires_grad_(True), tp)
    ttotal, tm = TTF.forward_train(tp, tcfg, _tb(batch), remat=remat)
    ttotal.backward()
    ttotal, tloss = ttotal.detach(), tm["loss"].detach()
    assert abs(float(tloss) - float(jm["loss"])) <= 1e-5 * abs(float(jm["loss"]))
    assert abs(float(ttotal) - float(jtotal)) <= 1e-5 * abs(float(jtotal))
    assert float(tm["aux"]) == float(jm["aux"]) == 0.0
    _close_trees(TP.tree_map(lambda t: t.grad, tp), jgrads)


def _jax_step(jcfg, opt_cfg):
    """Built as ``jaxlocal.train_job``'s step_fn."""
    @jax.jit
    def step_fn(params, opt_state, batch):
        def loss_fn(p):
            return JTF.forward_train(p, jcfg, batch, remat=False)

        (_, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        new_p, new_o, om = JA.adamw_update(grads, opt_state, params, opt_cfg)
        return new_p, new_o, dict(metrics, **om)

    return step_fn


@pytest.mark.parametrize("arch", ARCHS)
def test_one_adamw_step_matches_jax(arch):
    jcfg, tcfg, jp, tp = _model(arch, max_seq=16, tame=True)
    batch = _inputs(jcfg, seed=19)
    jnew, jopt, jmet = _jax_step(jcfg, JA.AdamWConfig(**OPT))(jp, JA.adamw_init(jp), _jb(batch))
    b, s = batch["tokens"].shape  # the shape sizes only the bundle's input_specs
    shape = TC.ShapeConfig("t", s + (tcfg.n_img_tokens if tcfg.family == "vlm" else 0), b,
                           "train")
    tnew, topt, tmet = make_train_step(tcfg, None, shape, TA.AdamWConfig(**OPT),
                                       remat=False).fn(tp, TA.adamw_init(tp), _tb(batch))
    for k in ("loss", "grad_norm", "lr"):
        assert abs(float(tmet[k]) - float(jmet[k])) <= 1e-5 * abs(float(jmet[k])), k
    assert int(topt["step"]) == int(jopt["step"]) == 1
    _close_trees(topt["mu"], jopt["mu"])
    _close_trees(topt["nu"], jopt["nu"])
    _close_trees(tnew, jnew)


# -- the stub frontend and the launchers ------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("arch", ARCHS + ["gemma-2b"])
def test_frontend_stubs_match_jax_bit_for_bit(arch, seed):
    """The same RandomState(seed + 17) draws, times 0.02: image patches for
    vlm, audio frames for encdec; the other families pass through."""
    jcfg, tcfg = _cfgs(arch)
    batch = {"tokens": np.arange(6, dtype=np.int32).reshape(2, 3),
             "mask": np.ones((2, 3), np.float32)}
    want = JD.with_frontend_stubs(dict(batch), jcfg, seed=seed)
    got = TD.with_frontend_stubs(dict(batch), tcfg, seed=seed)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    extra = {"phi-3-vision-4.2b": "img_embeds", "whisper-large-v3": "enc_frames"}.get(arch)
    assert sorted(got) == sorted(list(batch) + ([extra] if extra else []))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_runs_on_the_cpu(arch):
    """The loop attaches the stubs to every batch: its first loss is the
    port's forward_train on the first batch with the stubs, from the same
    init."""
    out = TT.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
                   "--batch", "2", "--seq", "16"])
    assert out["state"] == "done" and len(out["history"]) == 2
    assert all(np.isfinite(out["history"]))
    cfg = TC.get_smoke_config(arch)
    _, params = init_model(cfg, seed=0, max_seq=16, device="cpu")
    ds = TD.SyntheticDataset(TD.DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2))
    batch = TD.with_frontend_stubs(ds.batch(0), cfg, seed=0)
    with torch.no_grad():
        _, m = TTF.forward_train(params, cfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(out["history"][0] - float(m["loss"])) <= 1e-6 * abs(float(m["loss"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_and_serve_launcher_refuse_the_family(arch):
    """As in the reference: its engine and serve CLI refuse encdec, and its
    engine cannot feed vlm's img_embeds; both decode through prefill and
    decode_step."""
    cfg = TC.get_smoke_config(arch)
    _, params = init_model(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match=f"{cfg.family}.*decode_step"):
        ServingEngine(cfg, params, device="cpu")
    with pytest.raises(SystemExit, match=f"serve: .*{cfg.family!r}"):
        serve.main(["--arch", arch, "--device", "cpu", "--requests", "1"])
