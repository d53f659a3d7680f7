"""The port's selective scans, SSM mixer and hybrid (hymba) model against the
JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; params
are made by the JAX package and carried over with ``params_from_numpy``.  The
JAX scan kernels run in interpret mode on a few tiny cases (interpret mode
costs seconds a call); wider sweeps hold the port's wrappers against the JAX
package's plain versions in ``repro.kernels.ref``.  On the CPU the port's
wrappers run their plain versions (the CUDA kernels are held against those
on the card by chip_smoke.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as JC
from repro.kernels import ops as jops
from repro.kernels import ref as JR
from repro.models import decoding as JDEC
from repro.models import params as JP
from repro.models import ssm as JSSM
from repro.models import transformer as JTF
from repro.serving import ServingEngine as JEngine
from repro_torch.configs import base as TC
from repro_torch.kernels import ops
from repro_torch.kernels import ref as R
from repro_torch.kernels import ssm_scan as kssm
from repro_torch.launch import serve
from repro_torch.models import decoding as TDEC
from repro_torch.models import params as TP
from repro_torch.models import ssm as TSSM
from repro_torch.serving import ServingEngine
from repro_torch.steps import init_model

import _torch_threads  # noqa: F401  (one intra-op thread per test worker)

KTOL = dict(rtol=2e-5, atol=2e-5)  # kernels, f32
TOL = dict(rtol=2e-4, atol=2e-4)   # in-model f32 parity
SCAN_IMPLS = ["assoc", "chunked", "chunked_u"]
j_ssm_forward = jax.jit(JSSM.ssm_forward, static_argnames=("cfg",))
j_ssm_decode = jax.jit(JSSM.ssm_decode, static_argnames=("cfg",))
j_prefill = jax.jit(JDEC.prefill, static_argnames=("cfg", "max_len"))
j_decode_step = jax.jit(JDEC.decode_step, static_argnames=("cfg",))
j_scan_ref = jax.jit(JR.ssm_scan_ref)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _scan_inputs(b, s, di, n, seed):
    """dA in (0, 1) like exp(delta A) with A < 0, as tests/test_kernels.py."""
    rng = np.random.default_rng(seed)
    dA = (1 / (1 + np.exp(-(rng.standard_normal((b, s, di, n)) + 2.0)))).astype(np.float32)
    dBx = (rng.standard_normal((b, s, di, n)) * 0.1).astype(np.float32)
    C = rng.standard_normal((b, s, n)).astype(np.float32)
    return dA, dBx, C


def _fused_inputs(b, s, di, n, seed):
    rng = np.random.default_rng(seed)
    delta = np.log1p(np.exp(rng.standard_normal((b, s, di)))).astype(np.float32)
    B = rng.standard_normal((b, s, n)).astype(np.float32)
    C = rng.standard_normal((b, s, n)).astype(np.float32)
    x = rng.standard_normal((b, s, di)).astype(np.float32)
    A = (-np.exp(rng.standard_normal((di, n)))).astype(np.float32)
    return delta, B, C, x, A


def _cfgs(scan_impl="assoc", **kw):
    jcfg = JC.get_smoke_config("hymba-1.5b", **kw)
    tcfg = TC.get_smoke_config("hymba-1.5b", **kw)
    return (dataclasses.replace(jcfg, ssm=dataclasses.replace(jcfg.ssm, scan_impl=scan_impl)),
            dataclasses.replace(tcfg, ssm=dataclasses.replace(tcfg.ssm, scan_impl=scan_impl)))


def _carry(jparams):
    return TP.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")


# -- the scans against the JAX Pallas kernels (interpret mode) ---------------------


@pytest.mark.parametrize("b,s,di,n,chunk", [
    (2, 16, 16, 8, 8),   # two chunks
    (1, 13, 8, 4, 8),    # ragged S: JAX pads 13 -> 16 with identity steps
])
def test_ssm_scan_matches_jax_kernel(b, s, di, n, chunk):
    dA, dBx, C = _scan_inputs(b, s, di, n, seed=100 + s)
    y_want, h_want = jops.ssm_scan(*_j(dA, dBx, C), chunk=chunk, interpret=True)
    y_got, h_got = ops.ssm_scan(*_t(dA, dBx, C))
    assert y_got.shape == (b, s, di) and h_got.shape == (b, di, n)
    assert y_got.dtype == h_got.dtype == torch.float32
    _close(y_got, y_want, KTOL)
    _close(h_got, h_want, KTOL)


@pytest.mark.parametrize("b,s,di,n,chunk", [
    (1, 13, 8, 4, 8),    # ragged S: JAX pads 13 -> 16 with delta = 0
])
def test_ssm_scan_fused_matches_jax_kernel(b, s, di, n, chunk):
    delta, B, C, x, A = _fused_inputs(b, s, di, n, seed=200 + s)
    y_want, h_want = jops.ssm_scan_fused(*_j(delta, B, C, x, A), chunk=chunk, interpret=True)
    y_got, h_got = ops.ssm_scan_fused(*_t(delta, B, C, x, A))
    _close(y_got, y_want, KTOL)
    _close(h_got, h_want, KTOL)


# -- the scans against the JAX package's plain versions: wider sweeps -------------


SWEEP = [(2, 64, 32, 8), (1, 128, 16, 4), (2, 50, 8, 16), (1, 1, 64, 16), (3, 77, 24, 32),
         (1, 9, 5, 1)]


@pytest.mark.parametrize("b,s,di,n", SWEEP)
def test_ssm_scan_matches_jax_ref(b, s, di, n):
    dA, dBx, C = _scan_inputs(b, s, di, n, seed=300 + s + di)
    y_want, h_want = j_scan_ref(*_j(dA, dBx, C))
    y_got, h_got = ops.ssm_scan(*_t(dA, dBx, C))
    _close(y_got, y_want, KTOL)
    _close(h_got, h_want, KTOL)


@pytest.mark.parametrize("b,s,di,n", SWEEP)
def test_ssm_scan_fused_matches_jax_ref(b, s, di, n):
    delta, B, C, x, A = _fused_inputs(b, s, di, n, seed=400 + s + di)
    jd, jB, jC, jx, jA = _j(delta, B, C, x, A)
    y_want, h_want = j_scan_ref(*JR.ssm_discretize(jd, jB, jx, jA), jC)
    y_got, h_got = ops.ssm_scan_fused(*_t(delta, B, C, x, A))
    _close(y_got, y_want, KTOL)
    _close(h_got, h_want, KTOL)


def test_ssm_discretize_matches_jax():
    delta, B, _, x, A = _fused_inputs(2, 7, 12, 4, seed=5)
    want = JR.ssm_discretize(*_j(delta, B, x, A))
    got = R.ssm_discretize(*_t(delta, B, x, A))
    for g, w in zip(got, want):
        _close(g, w, KTOL)


def test_identity_steps_keep_h_last():
    """Steps with dA = 1, dBx = 0 (K4) or delta = 0 (K3) leave h as it was,
    and C = 0 gives y = 0 there: the JAX wrappers' padding, exactly."""
    dA, dBx, C = _scan_inputs(2, 20, 8, 4, seed=6)
    y0, h0 = ops.ssm_scan(*_t(dA[:, :13], dBx[:, :13], C[:, :13]))
    dA[:, 13:], dBx[:, 13:], C[:, 13:] = 1.0, 0.0, 0.0
    y1, h1 = ops.ssm_scan(*_t(dA, dBx, C))
    assert torch.equal(h1, h0) and torch.equal(y1[:, :13], y0)
    assert not bool(y1[:, 13:].any())
    delta, B, C, x, A = _fused_inputs(2, 20, 8, 4, seed=7)
    y0, h0 = ops.ssm_scan_fused(*_t(delta[:, :13], B[:, :13], C[:, :13], x[:, :13], A))
    delta[:, 13:] = 0.0
    y1, h1 = ops.ssm_scan_fused(*_t(delta, B, C, x, A))
    assert torch.equal(h1, h0) and torch.equal(y1[:, :13], y0)


# -- K3's chunk plan (kernels/ssm_scan.py::scan_chunks) ---------------------------


def _plan_scan(delta, B, C, x, A):
    """A plain chunked scan built from ``kssm.scan_chunks``: local scans of
    the chunks from h = 0, the carry in chunk order, then re-runs from each
    chunk's h_in (the order csrc/ssm_scan.cu computes them in)."""
    b, s, di = delta.shape
    plan = kssm.scan_chunks(s)

    def walk(h, lo, hi, y=None):
        total = torch.zeros(b, di)
        for t in range(lo, hi):
            dl = delta[:, t, :, None]
            h = torch.exp(dl * A) * h + dl * B[:, t, None, :] * x[:, t, :, None]
            total = total + delta[:, t]
            if y is not None:
                y[:, t] = (h * C[:, t, None, :]).sum(-1)
        return h, total

    h_in = [torch.zeros(b, di, A.shape[1])]
    for lo, hi in plan:
        end, total = walk(h_in[0].new_zeros(h_in[0].shape), lo, hi)
        h_in.append(torch.exp(A * total[..., None]) * h_in[-1] + end)
    y = torch.empty(b, s, di)
    for (lo, hi), h0 in zip(plan, h_in):
        walk(h0, lo, hi, y)
    return y, h_in[-1]


@pytest.mark.parametrize("s", [0, 1, 31, 32, 33, 77, 512, 1000])
def test_scan_chunks_are_fixed_and_cover_the_sequence(s):
    """Chunks of SCAN_CHUNK steps from t = 0, in order, the last one ragged:
    a longer sequence keeps every whole chunk of a shorter one."""
    plan = kssm.scan_chunks(s)
    assert [t for lo, hi in plan for t in range(lo, hi)] == list(range(s))
    assert all(lo % kssm.SCAN_CHUNK == 0 and 0 < hi - lo <= kssm.SCAN_CHUNK for lo, hi in plan)
    longer = kssm.scan_chunks(s + 45)
    assert longer[:s // kssm.SCAN_CHUNK] == plan[:s // kssm.SCAN_CHUNK]


@pytest.mark.parametrize("s", [1, 31, 77, 512])
def test_chunk_plan_scan_matches_ref(s):
    delta, B, C, x, A = _t(*_fused_inputs(2, s, 8, 16, seed=500 + s))
    y_want, h_want = R.ssm_scan_ref(*R.ssm_discretize(delta, B, x, A), C)
    y_got, h_got = _plan_scan(delta, B, C, x, A)
    _close(y_got, y_want, KTOL)
    _close(h_got, h_want, KTOL)


def test_chunk_plan_keeps_identity_steps_exact():
    """A tail of delta = 0 (and C = 0) steps after step 437 of 512 leaves
    h_last and y bit for bit as the 437-step scan gives them, and y = 0 on
    the tail: the plan's chunks do not move with S."""
    delta, B, C, x, A = _fused_inputs(1, 512, 8, 16, seed=7)
    y0, h0 = _plan_scan(*_t(delta[:, :437], B[:, :437], C[:, :437], x[:, :437], A))
    delta[:, 437:], C[:, 437:] = 0.0, 0.0
    y1, h1 = _plan_scan(*_t(delta, B, C, x, A))
    assert torch.equal(h1, h0) and torch.equal(y1[:, :437], y0)
    assert not bool(y1[:, 437:].any())


# -- the SSM mixer against repro.models.ssm ---------------------------------------


def _mixer(scan_impl="assoc"):
    jcfg, tcfg = _cfgs(scan_impl)
    jp = JP.init_params(jax.random.PRNGKey(0), JSSM.ssm_defs(jcfg))
    return jcfg, tcfg, jp, _carry(jp)


def test_causal_conv_matches_jax():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 6, 16)).astype(np.float32)
    w = rng.standard_normal((4, 16)).astype(np.float32)
    bias = rng.standard_normal(16).astype(np.float32)
    state = rng.standard_normal((2, 3, 16)).astype(np.float32)
    for st in (None, state):
        want = JSSM._causal_conv(*_j(x, w, bias), None if st is None else jnp.asarray(st))
        got = TSSM._causal_conv(*_t(x, w, bias), None if st is None else _t(st)[0])
        _close(got[0], want[0], KTOL)
        _close(got[1], want[1], KTOL)


@pytest.mark.parametrize("scan_impl", SCAN_IMPLS)
def test_ssm_forward_matches_jax(scan_impl):
    jcfg, tcfg, jp, tp = _mixer(scan_impl)
    x = np.random.default_rng(9).standard_normal((2, 24, jcfg.d_model)).astype(np.float32)
    want, jst = j_ssm_forward(jp, jnp.asarray(x), cfg=jcfg)
    got, tst = TSSM.ssm_forward(tp, torch.from_numpy(x), tcfg)
    _close(got, want)
    _close(tst["conv"], jst["conv"])
    _close(tst["ssm"], jst["ssm"])
    assert tst["ssm"].dtype == torch.float32 and tst["conv"].dtype == got.dtype


def test_ssm_decode_matches_jax():
    jcfg, tcfg, jp, tp = _mixer()
    rng = np.random.default_rng(10)
    di, n, k = 2 * jcfg.d_model, jcfg.ssm.d_state, jcfg.ssm.d_conv
    x = rng.standard_normal((3, 1, jcfg.d_model)).astype(np.float32)
    conv = rng.standard_normal((3, k - 1, di)).astype(np.float32)
    h = (rng.standard_normal((3, di, n)) * 0.5).astype(np.float32)
    want, jst = j_ssm_decode(jp, jnp.asarray(x), {"conv": jnp.asarray(conv),
                                                  "ssm": jnp.asarray(h)}, cfg=jcfg)
    state = dict(zip(("conv", "ssm"), _t(conv, h)))
    got, tst = TSSM.ssm_decode(tp, torch.from_numpy(x), state, tcfg)
    _close(got, want)
    _close(tst["conv"], jst["conv"])
    _close(tst["ssm"], jst["ssm"])
    np.testing.assert_array_equal(state["ssm"].numpy(), h)  # the old state is not written


def test_params_from_numpy_keeps_the_f32_ssm_leaves_bit_for_bit():
    jcfg, _ = _cfgs(dtype="bfloat16")
    jp = JP.init_params(jax.random.PRNGKey(4), JTF.block_defs(jcfg))
    tp = _carry(jp)
    for key in ("dt_bias", "A_log", "D"):
        assert tp["ssm"][key].dtype == torch.float32
        np.testing.assert_array_equal(tp["ssm"][key].numpy().view(np.uint32),
                                      np.asarray(jp["ssm"][key]).view(np.uint32))
    assert tp["mix_w"].dtype == torch.float32
    np.testing.assert_array_equal(tp["mix_w"].numpy(), np.asarray(jp["mix_w"]))
    assert tp["ssm"]["conv_w"].dtype == torch.bfloat16


# -- hymba-smoke prefill + decode, engine and launcher ---------------------------


@pytest.mark.parametrize("scan_impl", ["assoc", "chunked"])
def test_hybrid_prefill_and_decode_match_jax(scan_impl):
    jcfg, tcfg = _cfgs(scan_impl)
    jp = JP.init_params(jax.random.PRNGKey(3), JTF.model_defs(jcfg))
    tp = _carry(jp)
    rng = np.random.default_rng(16)
    toks = rng.integers(1, jcfg.vocab, size=(2, 12)).astype(np.int32)
    jl, jc = j_prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, max_len=20)
    tl, tc = TDEC.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks).long()}, max_len=20)
    assert set(tc) == set(jc) == {"k", "v", "pos", "conv", "ssm"}

    def check():
        _close(tl, jl)
        for key in ("k", "v", "conv", "ssm"):
            assert tuple(tc[key].shape) == jc[key].shape
            assert str(tc[key].dtype).replace("torch.", "") == jc[key].dtype.name
            _close(tc[key], jc[key])
        np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))

    check()
    for _ in range(4):
        nxt = rng.integers(1, jcfg.vocab, size=(2, 1)).astype(np.int32)
        jl, jc = j_decode_step(jp, jcfg, jc, jnp.asarray(nxt))
        tl, tc = TDEC.decode_step(tp, tcfg, tc, torch.from_numpy(nxt).long())
        check()


def test_engine_greedy_tokens_match_jax_engine_on_hymba():
    """5 exact-length requests through 2 slots (slots refill); one request is
    done after its first token, which comes from the prefill logits."""
    jcfg, tcfg = _cfgs()
    jp = JP.init_params(jax.random.PRNGKey(0), JTF.model_defs(jcfg))
    tp = _carry(jp)
    rng = np.random.default_rng(21)
    news = [5, 1, 7, 3, 6]
    prompts = [[int(t) for t in rng.integers(1, jcfg.vocab, size=8)] for _ in news]
    kw = dict(max_batch=2, max_len=32, prefill_len=8)
    jeng = JEngine(jcfg, jp, **kw)
    teng = ServingEngine(tcfg, tp, device="cpu", **kw)
    for prompt, new in zip(prompts, news):
        assert jeng.submit(prompt, max_new_tokens=new) == teng.submit(prompt, max_new_tokens=new)
    want = jeng.run_until_idle()
    got = teng.run_until_idle()
    assert got == want
    assert [len(got[i]) for i in range(5)] == news
    assert teng.stats == jeng.stats


def test_engine_wants_exact_length_prompts_for_hymba():
    _, tcfg = _cfgs()
    _, params = init_model(tcfg, device="cpu")
    eng = ServingEngine(tcfg, params, max_batch=1, max_len=16, prefill_len=8, device="cpu")
    with pytest.raises(ValueError, match="exact-length"):
        eng.submit([1, 2, 3])
    eng.submit(list(range(1, 9)), max_new_tokens=2)
    assert len(eng.run_until_idle()[0]) == 2


@pytest.mark.parametrize("scan_impl", ["assoc", "chunked"])
def test_serve_launcher_runs_hymba_on_the_cpu(scan_impl, capsys):
    summary = serve.main(["--arch", "hymba-1.5b", "--device", "cpu", "--requests", "3",
                          "--max-batch", "2", "--max-new", "3", "--prefill-len", "8",
                          "--max-len", "16", "--scan-impl", scan_impl, "--json"])
    assert summary["completed"] == 3 and summary["tokens"] == 9
    assert summary["scan_impl"] == scan_impl and summary["prefills"] == 3
    assert summary["device"] == "cpu" and summary["arch"] == "hymba-1.5b"
