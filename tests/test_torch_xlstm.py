"""The port's xlstm family (``repro_torch.models.xlstm``, family ``ssm``)
against the JAX package's, on the CPU at smoke size in f32: the mLSTM and
sLSTM blocks, prefill + decode, ``forward_train``'s loss and grads, one
AdamW step, checkpoints, the serving engine and the launchers.

Params are made by the JAX package and carried over with
``params_from_numpy``; other inputs are made with numpy from a seed.
Tolerance: 2e-4 (in-model parity).  No kernel is involved, in either package.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import steps as JS
from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.configs import base as JC
from repro.core.objectstore import ObjectStore as JObjectStore
from repro.models import decoding as JDEC
from repro.models import params as JP
from repro.models import transformer as JTF
from repro.models import xlstm as JXL
from repro.optim import adamw as JA
from repro.serving import ServingEngine as JEngine
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import base as TC
from repro_torch.core import ObjectStore
from repro_torch.kernels import ops as kops
from repro_torch.launch import serve
from repro_torch.launch import train as TT
from repro_torch.models import decoding as TDEC
from repro_torch.models import transformer as TTF
from repro_torch.models import xlstm as TXL
from repro_torch.models.params import params_from_numpy, tree_leaves, tree_map
from repro_torch.optim import adamw as TA
from repro_torch.serving import ServingEngine
from repro_torch.steps import init_model, make_train_step
from test_torch_train import OPT, _close_new_params, _close_trees, _jax_step

import _torch_threads  # noqa: F401  (one intra-op thread per test worker)

TOL = dict(rtol=2e-4, atol=2e-4)  # in-model f32 parity
ARCH = "xlstm-125m"
j_mlstm_forward = jax.jit(JXL.mlstm_forward, static_argnames=("cfg",))
j_mlstm_decode = jax.jit(JXL.mlstm_decode, static_argnames=("cfg",))
j_slstm_forward = jax.jit(JXL.slstm_forward, static_argnames=("cfg",))
j_prefill = jax.jit(JDEC.prefill, static_argnames=("cfg", "max_len"))
j_decode_step = jax.jit(JDEC.decode_step, static_argnames=("cfg",))


def _cfgs(**kw):
    return JC.get_smoke_config(ARCH, **kw), TC.get_smoke_config(ARCH, **kw)


def _carry(jtree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jtree), "cpu")


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _close_states(got, want):
    """Two state dicts: the same keys, shapes, dtypes and values."""
    assert set(got) == set(want)
    for key in want:
        assert tuple(got[key].shape) == want[key].shape, key
        assert str(got[key].dtype).replace("torch.", "") == want[key].dtype.name, key
        _close(got[key], want[key])


def _x(b, s, d, seed):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)


def _block(defs_fn, seed):
    jcfg, tcfg = _cfgs()
    jp = JP.init_params(jax.random.PRNGKey(seed), defs_fn(jcfg))
    return jcfg, tcfg, jp, _carry(jp)


@pytest.fixture
def kernel_calls(monkeypatch):
    """Calls of every kernel wrapper, counted: the xlstm family reaches none."""
    counts = dict.fromkeys(kops.KERNELS, 0)
    for name in counts:
        def counted(*args, _fn=getattr(kops, name), _name=name):
            counts[_name] += 1
            return _fn(*args)
        monkeypatch.setattr(kops, name, counted)
    return counts


# -- the blocks ----------------------------------------------------------------------


def test_layer_kinds_put_an_slstm_every_4th_block():
    jcfg, tcfg = JC.get_config(ARCH), TC.get_config(ARCH)
    kinds = TTF.xlstm_layer_kinds(tcfg)
    assert kinds == JTF.xlstm_layer_kinds(jcfg)
    assert [i for i, k in enumerate(kinds) if k == "slstm"] == [3, 7, 11]
    assert TTF.xlstm_layer_kinds(TC.get_smoke_config(ARCH)) == ["mlstm", "slstm"]


def test_mlstm_forward_and_its_folded_state_match_jax():
    jcfg, tcfg, jp, tp = _block(JXL.mlstm_defs, 1)
    x = _x(2, 11, jcfg.d_model, 2) * 2
    want, jst = j_mlstm_forward(jp, jnp.asarray(x), cfg=jcfg)
    got, tst = TXL.mlstm_forward(tp, torch.from_numpy(x), tcfg)
    _close(got, want)
    _close_states(tst, jst)


def test_mlstm_decode_matches_jax():
    """Three steps from the state a prefill folded; the given state is not
    written."""
    jcfg, tcfg, jp, tp = _block(JXL.mlstm_defs, 3)
    x = _x(2, 13, jcfg.d_model, 4)
    _, jst = j_mlstm_forward(jp, jnp.asarray(x[:, :10]), cfg=jcfg)
    _, tst = TXL.mlstm_forward(tp, torch.from_numpy(x[:, :10].copy()), tcfg)
    for t in range(10, 13):
        before = {k: v.clone() for k, v in tst.items()}
        want, jst = j_mlstm_decode(jp, jnp.asarray(x[:, t:t + 1]), jst, cfg=jcfg)
        got, new = TXL.mlstm_decode(tp, torch.from_numpy(x[:, t:t + 1].copy()), tst, tcfg)
        assert all(torch.equal(tst[k], before[k]) for k in tst)
        tst = new
        _close(got, want)
        _close_states(tst, jst)


def test_mlstm_decode_from_the_initial_state_matches_jax():
    jcfg, tcfg, jp, tp = _block(JXL.mlstm_defs, 5)
    x = _x(3, 1, jcfg.d_model, 6)
    want, jst = j_mlstm_decode(jp, jnp.asarray(x), JXL.init_mlstm_state(jcfg, 3), cfg=jcfg)
    init = TXL.init_mlstm_state(tcfg, 3, device="cpu")
    _close_states(init, JXL.init_mlstm_state(jcfg, 3))
    got, tst = TXL.mlstm_decode(tp, torch.from_numpy(x), init, tcfg)
    _close(got, want)
    _close_states(tst, jst)


@pytest.mark.parametrize("from_state", [False, True])
def test_slstm_forward_matches_jax(from_state):
    """Sequential over 9 steps, from the initial state or from the state
    after 5 other steps; its residual and post-FFN are inside."""
    jcfg, tcfg, jp, tp = _block(JXL.slstm_defs, 7)
    x = _x(2, 14, jcfg.d_model, 8)
    jst = tst = None
    if from_state:
        _, jst = j_slstm_forward(jp, jnp.asarray(x[:, :5]), cfg=jcfg)
        _, tst = TXL.slstm_forward(tp, torch.from_numpy(x[:, :5].copy()), tcfg)
        _close_states(tst, jst)
    want, jst = j_slstm_forward(jp, jnp.asarray(x[:, 5:]), cfg=jcfg, state=jst)
    got, tst = TXL.slstm_forward(tp, torch.from_numpy(x[:, 5:].copy()), tcfg, tst)
    _close(got, want)
    _close_states(tst, jst)


def test_slstm_decode_matches_jax():
    jcfg, tcfg, jp, tp = _block(JXL.slstm_defs, 9)
    x = _x(2, 7, jcfg.d_model, 10)
    _, jst = j_slstm_forward(jp, jnp.asarray(x[:, :4]), cfg=jcfg)
    _, tst = TXL.slstm_forward(tp, torch.from_numpy(x[:, :4].copy()), tcfg)
    for t in range(4, 7):
        want, jst = JXL.slstm_decode(jp, jnp.asarray(x[:, t:t + 1]), jst, jcfg)
        got, tst = TXL.slstm_decode(tp, torch.from_numpy(x[:, t:t + 1].copy()), tst, tcfg)
        _close(got, want)
        _close_states(tst, jst)


def test_k_is_scaled_by_sqrt_dh_rounded_to_the_activation_dtype():
    """At xlstm-125m's dh = 384, sqrt(dh) = 19.596 is 19.625 in bf16."""
    _, tcfg = _cfgs(dtype="bfloat16", d_model=768, n_heads=4)
    dp = int(tcfg.xlstm.proj_factor * tcfg.d_model)
    eye = torch.eye(dp, dtype=torch.bfloat16).reshape(dp, 4, dp // 4)
    p = dict(init_model(tcfg, device="cpu")[1]["blocks"][0], w_q=eye, w_k=eye)
    x = torch.randn(1, 3, 768, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    q, k = TXL._mlstm_qkvgates(p, x, tcfg)[:2]
    assert torch.equal(k, q / torch.tensor(19.625, dtype=torch.bfloat16))


# -- the model -----------------------------------------------------------------------


def _model(seed=3, **kw):
    jcfg, tcfg = _cfgs(**kw)
    _, jp = JS.init_model(jcfg, seed=seed, max_seq=16)
    return jcfg, tcfg, jp, _carry(jp)


def test_model_defs_are_a_list_of_blocks():
    _, tcfg = _cfgs()
    defs = TTF.model_defs(tcfg)
    assert isinstance(defs["blocks"], list) and len(defs["blocks"]) == tcfg.n_layers
    assert "w_up" in defs["blocks"][0] and "r_h" in defs["blocks"][1]


def test_prefill_and_six_decode_steps_match_jax(kernel_calls):
    """Prefill of 10 tokens at B = 2, then 6 decode steps: logits and every
    state leaf (batch-first) match; no kernel is called."""
    jcfg, tcfg, jp, tp = _model()
    rng = np.random.default_rng(16)
    toks = rng.integers(1, jcfg.vocab, size=(2, 10)).astype(np.int32)
    jl, jc = j_prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, max_len=32)
    tl, tc = TDEC.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks).long()}, max_len=32)

    def check():
        _close(tl, jl)
        assert len(tc["blocks"]) == len(jc["blocks"]) == tcfg.n_layers
        for got, want in zip(tc["blocks"], jc["blocks"]):
            _close_states(got, want)
            assert all(t.shape[0] == 2 for t in got.values())
        np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))

    check()
    for _ in range(6):
        nxt = rng.integers(1, jcfg.vocab, size=(2, 1)).astype(np.int32)
        jl, jc = j_decode_step(jp, jcfg, jc, jnp.asarray(nxt))
        tl, tc = TDEC.decode_step(tp, tcfg, tc, torch.from_numpy(nxt).long())
        check()
    assert set(kernel_calls.values()) == {0}


def test_init_cache_matches_jax():
    jcfg, tcfg = _cfgs()
    jc = JDEC.init_cache(jcfg, 3, 16)
    tc = TDEC.init_cache(tcfg, 3, 16, device="cpu")
    for got, want in zip(tc["blocks"], jc["blocks"]):
        _close_states(got, want)
    assert tc["pos"].dtype == torch.int32 and tuple(tc["pos"].shape) == (3,)


def test_forward_train_loss_and_grads_match_jax():
    jcfg, tcfg, jp, tp = _model()
    batch = _batch(jcfg.vocab, seed=2)
    (jtotal, jm), jgrads = jax.value_and_grad(
        lambda p: JTF.forward_train(p, jcfg, _jb(batch), remat=False), has_aux=True)(jp)
    tree_map(lambda t: t.requires_grad_(True), tp)
    ttotal, tm = TTF.forward_train(tp, tcfg, _tb(batch))
    ttotal.backward()
    np.testing.assert_allclose(float(ttotal.detach()), float(jtotal), rtol=1e-5)
    np.testing.assert_allclose(float(tm["loss"].detach()), float(jm["loss"]), rtol=1e-5)
    assert tm["aux"].dtype == torch.float32 and float(tm["aux"]) == float(jm["aux"]) == 0.0
    _close_trees(tree_map(lambda t: t.grad, tp), jgrads)


def test_one_adamw_step_matches_jax():
    jcfg, tcfg, jp, tp = _model()
    batch = _batch(jcfg.vocab, seed=3)
    jnew, jopt, jmet = _jax_step(jcfg, JA.AdamWConfig(**OPT))(jp, JA.adamw_init(jp),
                                                               _jb(batch))
    tnew, topt, tmet = make_train_step(tcfg, None, TC.ShapeConfig("t", 16, 2, "train"), TA.AdamWConfig(**OPT)).fn(
        tp, TA.adamw_init(tp), _tb(batch))
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]), rtol=1e-5)
    _close_new_params(tnew, jnew, jopt["mu"], OPT["lr"])
    _close_trees(topt["mu"], jopt["mu"])
    _close_trees(topt["nu"], jopt["nu"])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_of_listed_blocks_cross_loads(tmp_path, writer):
    """The list of blocks is written as ``['blocks'][0]['w_up']``, as
    ``jax.tree_util.keystr`` writes it, and each package reads the other's."""
    _, _, jp, tp = _model()
    jm = JCheckpointManager(JObjectStore(root=str(tmp_path)), "ckpt", "run")
    tm = CheckpointManager(ObjectStore(root=str(tmp_path)), "ckpt", "run")
    if writer == "jax":
        jm.save(2, {"params": jp})
        got = tree_leaves(tm.restore(2, {"params": tree_map(torch.zeros_like, tp)})[0])
        want = jax.tree_util.tree_leaves(jp)
    else:
        tm.save(2, {"params": tp})
        like = jax.tree_util.tree_map(jnp.zeros_like, jp)
        got = jax.tree_util.tree_leaves(jm.restore(2, {"params": like})[0])
        want = tree_leaves(tp)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), _np(w))
    raw = json.loads((tmp_path / "ckpt" / "run" / "step_00000002" / "MANIFEST.json").read_text())
    assert "['params']['blocks'][0]['w_up']" in [e["path"] for e in raw["leaves"]]


def _batch(vocab, b=2, s=16, seed=0):
    rng = np.random.default_rng(seed)
    mask = np.ones((b, s), np.float32)
    mask[:, : s // 3] = 0.0
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "targets": rng.integers(0, vocab, (b, s)).astype(np.int32), "mask": mask}


def _tb(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# -- serving -------------------------------------------------------------------------


NEWS = [5, 1, 6, 3]


def _requests(vocab, n=8):
    rng = np.random.default_rng(21)
    return [[int(t) for t in rng.integers(1, vocab, size=n)] for _ in NEWS]


def _alone(tp, tcfg, prompt, new):
    """Greedy tokens of one request decoded alone through prefill and
    decode_step at B = 1."""
    logits, cache = TDEC.prefill(tp, tcfg, {"tokens": torch.tensor([prompt])}, max_len=32)
    out = [int(logits[0, -1].argmax())]
    while len(out) < new:
        logits, cache = TDEC.decode_step(tp, tcfg, cache, torch.tensor([[out[-1]]]))
        out.append(int(logits[0, -1].argmax()))
    return out


def test_engine_matches_jax_engine_at_one_slot(kernel_calls):
    """At max_batch=1 the reference engine's insertion of the mLSTM conv
    state (axis 1, ROADMAP.md R3) lands on slot 0 as axis 0 does, so the two
    engines agree token for token; each request is also its tokens decoded
    alone.  The first token comes from the prefill logits."""
    jcfg, tcfg, jp, tp = _model(seed=0)
    prompts = _requests(jcfg.vocab)
    kw = dict(max_batch=1, max_len=32, prefill_len=8)
    jeng = JEngine(jcfg, jp, **kw)
    teng = ServingEngine(tcfg, tp, device="cpu", **kw)
    for prompt, new in zip(prompts, NEWS):
        assert jeng.submit(prompt, max_new_tokens=new) == teng.submit(prompt, max_new_tokens=new)
    want = jeng.run_until_idle()
    got = teng.run_until_idle()
    assert got == want
    assert [len(got[i]) for i in range(len(NEWS))] == NEWS
    assert teng.stats == jeng.stats
    assert got == {i: _alone(tp, tcfg, p, n) for i, (p, n) in enumerate(zip(prompts, NEWS))}
    assert set(kernel_calls.values()) == {0}


def test_engine_with_two_slots_matches_each_request_decoded_alone():
    """R3 (ROADMAP.md): the reference engine's ``_batch_axis`` matches
    ``'conv'`` and inserts the mLSTM conv state (B,3,dp) on axis 1, so with
    more than one slot a request admitted into slot k > 0 overwrites slot
    0's conv state, against that engine's own comment that xlstm states are
    batch-first.  The port inserts every xlstm state leaf on axis 0, as
    intended: each request's tokens at max_batch=2 (slots refill) are its
    tokens decoded alone.  On these requests the reference engine's are not
    (its slip shows here)."""
    jcfg, tcfg, jp, tp = _model(seed=0)
    prompts = _requests(jcfg.vocab)
    kw = dict(max_batch=2, max_len=32, prefill_len=8)
    eng = ServingEngine(tcfg, tp, device="cpu", **kw)
    jeng = JEngine(jcfg, jp, **kw)
    for prompt, new in zip(prompts, NEWS):
        eng.submit(prompt, max_new_tokens=new)
        jeng.submit(prompt, max_new_tokens=new)
    got = eng.run_until_idle()
    alone = {i: _alone(tp, tcfg, p, n) for i, (p, n) in enumerate(zip(prompts, NEWS))}
    assert got == alone
    assert eng.stats["prefills"] == len(NEWS)
    assert jeng.run_until_idle() != alone


def test_engine_wants_exact_length_prompts_for_xlstm():
    _, tcfg = _cfgs()
    _, params = init_model(tcfg, device="cpu")
    eng = ServingEngine(tcfg, params, max_batch=1, max_len=16, prefill_len=8, device="cpu")
    with pytest.raises(ValueError, match="exact-length"):
        eng.submit([1, 2, 3])


def test_serve_launcher_runs_xlstm_on_the_cpu(capsys):
    summary = serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                          "--max-batch", "2", "--max-new", "3", "--prefill-len", "8",
                          "--max-len", "16", "--json"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == summary
    assert summary["completed"] == 3 and summary["tokens"] == 9
    assert summary["prefills"] == 3 and summary["scan_impl"] is None


def test_train_launcher_runs_xlstm_on_the_cpu(tmp_path, capsys):
    common = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2", "--seq", "16",
              "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    first = TT.main(common + ["--steps", "2"])
    assert first["state"] == "done" and all(np.isfinite(first["history"]))
    assert first["history"][-1] < first["history"][0]
    second = TT.main(common + ["--steps", "3"])
    assert "[train] resumed from step 2" in capsys.readouterr().out
    assert second["start_step"] == 2 and len(second["history"]) == 1
