"""The port's training path against the JAX package's, on the CPU at smoke
size: the loss, one AdamW step and three, the schedule and the clip, remat,
the synthetic data, checkpoints (which cross-load between the packages), the
train loop's crash and resume, the launcher, the kernel wrappers' refusal
to run under grad, and hybrid (hymba) training through the reference's
differentiable scans, with and without a sliding window.

Params are made by the JAX package (``repro.steps.init_model``) and carried
over with ``params_from_numpy``; other inputs are made with numpy from a
seed.  The one-step cases rescale wq and wk first (``_tame``), so the
attention scores are O(1) and the grads are not chaotic.  Tolerance: 2e-4
of the leaf's max |x| unless a case says otherwise.
"""
import dataclasses
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import steps as JS
from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.configs import base as JC
from repro.core.objectstore import ObjectStore as JObjectStore
from repro.data import pipeline as JD
from repro.models import transformer as JTF
from repro.optim import adamw as JA
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import base as TC
from repro_torch.core import ObjectStore
from repro_torch.data import pipeline as TD
from repro_torch.kernels import ops as kops
from repro_torch.launch import train as TT
from repro_torch.models import decoding as TDEC
from repro_torch.models import transformer as TTF
from repro_torch.models.params import params_from_numpy, tree_leaves, tree_map, tree_paths
from repro_torch.optim import adamw as TA
from repro_torch.steps import init_model, make_train_step

import _torch_threads  # noqa: F401  (one intra-op thread per test worker)

TOL = 2e-4
OPT = dict(lr=1e-2, warmup_steps=1, total_steps=10)  # the first step at the full lr


def _cfgs(arch="gemma-2b", **kw):
    return JC.get_smoke_config(arch, **kw), TC.get_smoke_config(arch, **kw)


def _carry(jtree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jtree), "cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol=TOL, what=""):
    """max |got - want| <= tol * max |want|."""
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    err, top = float(np.max(np.abs(g - w), initial=0)), float(np.max(np.abs(w), initial=0))
    assert err <= tol * top, f"{what}: max err {err:.3e} > {tol} x max |x| {top:.3e}"


def _close_trees(got, want, tol=TOL):
    jpaths = [jax.tree_util.keystr(p) for p, _ in
              jax.tree_util.tree_flatten_with_path(want)[0]]
    tpaths = [p for p, _ in tree_paths(got)]
    assert tpaths == jpaths
    for path, g, w in zip(tpaths, tree_leaves(got), jax.tree_util.tree_leaves(want)):
        _close(g, w, tol, path)


def _close_new_params(got, want, mu, lr):
    """Every new param within TOL of its leaf's max |x|, but for elements
    where f32 does not fix Adam's first step: after the clip a grad near
    zero is of the order of eps (1e-8), where g / (|g| + eps) turns on the
    grad's last digits, and the two packages' grads agree only to ~1e-5 of
    their leaf's max.  An element may miss TOL only if its first moment is
    within the moment tolerance of zero (|mu| <= TOL max |mu|); it may then
    differ by at most the step's bound, 2 lr; and such elements must be
    fewer than 0.1% of the params (the bf16 case's rule)."""
    n = off = 0
    for (path, g), w, m in zip(tree_paths(got), jax.tree_util.tree_leaves(want),
                               jax.tree_util.tree_leaves(mu)):
        w, m = np.asarray(w, np.float32), np.abs(np.asarray(m))
        d = np.abs(_np(g) - w)
        miss = d > TOL * np.abs(w).max()
        assert (m[miss] <= TOL * m.max()).all(), f"{path}: misses TOL where the grad is not ~0"
        assert (d[miss] <= 2 * lr).all(), f"{path}: max err {d.max():.3e} > 2 lr"
        off += int(miss.sum())
        n += w.size
    assert off < 1e-3 * n, f"{off} of {n} new params miss TOL"


def _rel(got, want):
    return abs(float(got) - float(want)) / abs(float(want))


def _batch(vocab, b=2, s=16, seed=0, partial=True):
    rng = np.random.default_rng(seed)
    mask = np.ones((b, s), np.float32)
    if partial:
        mask[:, : s // 3] = 0.0
        mask[1, -2:] = 0.0
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "targets": rng.integers(0, vocab, (b, s)).astype(np.int32), "mask": mask}


def _tb(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _model(arch="gemma-2b", seed=0, tame=False, **kw):
    jcfg, tcfg = _cfgs(arch, **kw)
    _, jp = JS.init_model(jcfg, seed=seed, max_seq=16)
    if tame:
        jp = _tame(jp, jcfg)
    return jcfg, tcfg, jp, _carry(jp)


def _tame(jp, jcfg):
    """The reference's params with wq and wk rescaled to std 1/sqrt(d_model),
    so the attention scores are O(1).  The reference draws wk at std 1 (its
    fan-in is n_kv_heads), so its scores run in the hundreds; the softmax
    backward of those near one-hot rows cancels, and the grads of two
    correct implementations then differ by percents.  From these params the
    two packages' f32 grads agree to ~1e-6 of their max."""
    attn = dict(jp["blocks"]["attn"])
    for name, heads in (("wq", jcfg.n_heads), ("wk", jcfg.n_kv_heads)):
        w = attn[name]
        attn[name] = (w.astype(jnp.float32) * np.sqrt(heads / jcfg.d_model)).astype(w.dtype)
    return dict(jp, blocks=dict(jp["blocks"], attn=attn))


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


# -- loss and forward --------------------------------------------------------------


@pytest.mark.parametrize("mask", ["partial", "zero"])
def test_cross_entropy_matches_jax(mask):
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    targets = rng.integers(0, 50, (3, 7)).astype(np.int32)
    m = (rng.random((3, 7)) > 0.4).astype(np.float32) if mask == "partial" else \
        np.zeros((3, 7), np.float32)
    want = JTF.cross_entropy(jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(m))
    got = TTF.cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets),
                            torch.from_numpy(m))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-7)
    if mask == "zero":
        assert float(got) == 0.0


@pytest.mark.parametrize("arch", ["gemma-2b", "phi3-mini-3.8b", "granite-moe-3b-a800m",
                                  "moonshot-v1-16b-a3b"])
def test_forward_train_matches_jax(arch):
    """total = loss + 0.01 aux; aux is the layers' summed moe load-balance
    loss, and zero for the dense family."""
    jcfg, tcfg, jp, tp = _model(arch)
    batch = _batch(jcfg.vocab, seed=2)
    jtotal, jm = JTF.forward_train(jp, jcfg, _jb(batch), remat=False)
    ttotal, tm = TTF.forward_train(tp, tcfg, _tb(batch), remat=False)
    assert _rel(tm["loss"], jm["loss"]) <= 1e-5
    assert _rel(ttotal, jtotal) <= 1e-5
    assert tm["aux"].dtype == torch.float32 and tm["aux"].shape == ()
    if tcfg.family == "moe":  # n_layers terms, each >= 1 (it is 1 when balanced)
        assert float(jm["aux"]) >= tcfg.n_layers and _rel(tm["aux"], jm["aux"]) <= 1e-5
    else:
        assert float(tm["aux"]) == float(jm["aux"]) == 0.0


# -- one AdamW step, and three -----------------------------------------------------


def _one_step(arch, dtype):
    """One step of each package from the same (tamed) params and batch, and
    JAX's f32 step from those params upcast (the bf16 step's exact-arithmetic
    yardstick; for f32 it is JAX's step itself)."""
    jcfg, tcfg, jp, tp = _model(arch, tame=True, dtype=dtype)
    batch = _batch(jcfg.vocab, seed=3)
    jnew, jopt, jmet = _jax_step(jcfg, JA.AdamWConfig(**OPT))(jp, JA.adamw_init(jp),
                                                               _jb(batch))
    tnew, topt, tmet = make_train_step(tcfg, None, TC.ShapeConfig("t", 16, 2, "train"), TA.AdamWConfig(**OPT),
                                       remat=False).fn(tp, TA.adamw_init(tp), _tb(batch))
    f32 = (jnew, jopt, jmet)
    if dtype != "float32":
        jcfg32 = dataclasses.replace(jcfg, dtype="float32")
        jp32 = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), jp)
        f32 = _jax_step(jcfg32, JA.AdamWConfig(**OPT))(jp32, JA.adamw_init(jp32), _jb(batch))
    return (jnew, jopt, jmet), (tnew, topt, tmet), f32


@pytest.mark.parametrize("arch", ["gemma-2b", "phi3-mini-3.8b", "granite-moe-3b-a800m"])
def test_one_adamw_step_matches_jax(arch):
    """For granite-moe the grads reach the router through the gates and the
    aux loss, and the experts through the kept pairs only."""
    (jnew, jopt, jmet), (tnew, topt, tmet), _ = _one_step(arch, "float32")
    assert _rel(tmet["loss"], jmet["loss"]) <= 1e-5
    if arch == "granite-moe-3b-a800m":
        assert _rel(tmet["aux"], jmet["aux"]) <= 1e-5
    else:
        assert float(tmet["aux"]) == float(jmet["aux"]) == 0.0
    assert _rel(tmet["grad_norm"], jmet["grad_norm"]) <= 1e-5
    assert _rel(tmet["lr"], jmet["lr"]) <= 1e-6
    assert topt["step"].dtype == torch.int32 and int(topt["step"]) == int(jopt["step"]) == 1
    _close_new_params(tnew, jnew, jopt["mu"], OPT["lr"])
    _close_trees(topt["mu"], jopt["mu"])
    _close_trees(topt["nu"], jopt["nu"])


def _bf16_ulps_off(got, want, strict_f32=True):
    """(elements of ``got``'s bf16 leaves more than one bf16 ulp of ``want``'s
    leaves away, elements of the bf16 leaves).  The f32 leaves (norm scales)
    hold to TOL, or with ``strict_f32=False`` are counted as the bf16 ones."""
    off = n = 0
    for (path, g), w in zip(tree_paths(got), want):
        if strict_f32:  # a tree of the same dtypes
            assert str(g.dtype).split(".")[-1] == str(w.dtype), path
        if g.dtype == torch.float32 and strict_f32:
            _close(g, w, what=path)
            continue
        w32 = _np(w)
        ulp = np.maximum(np.spacing(np.abs(w32)) * 2.0 ** 16, 2.0 ** -133)  # 8 of f32's 24 bits
        off += int(np.sum(np.abs(_np(g) - w32) > ulp))
        n += w32.size
    return off, n


def _max_drift(got, want):
    """The largest max |got - want| / max |want| over the leaves."""
    return max(float(np.abs(_np(g) - _np(w)).max() / np.abs(_np(w)).max())
               for g, w in zip(got, want))


BF16_PARAMS_OFF = 5e-3  # share of new params allowed more than one bf16 ulp off


def test_one_bf16_adamw_step_matches_jax():
    """bf16 params and grads, f32 moments, from the tamed params.  Loss and
    grad_norm hold to the kernels' bf16 tolerance (2e-2).  The two packages
    round the bf16 forward and backward in other places, so their bf16
    grads differ by ~1% of a leaf's max, as each package's differ from the
    f32 step's, and a grad near zero can take the other sign: JAX's own
    bf16 step lands more than one bf16 ulp from its f32 step (from the same
    params) in 0.25-0.32% of the new params, and the port's lands that far
    from JAX's bf16 step in 0.22-0.24%.  So fewer than 0.5% may be more
    than one ulp off JAX's bf16 step, mu holds to 2e-2 of max |x| and nu
    (squares: twice the relative error) to 4e-2.  And the port's step is
    no farther from JAX's f32 step than JAX's own bf16 step is, with 25% to
    spare, in new params off and in each moment."""
    (jnew, jopt, jmet), (tnew, topt, tmet), (fnew, fopt, _) = _one_step("gemma-2b", "bfloat16")
    assert _rel(tmet["loss"], jmet["loss"]) <= 2e-2
    assert _rel(tmet["grad_norm"], jmet["grad_norm"]) <= 2e-2
    assert _rel(tmet["lr"], jmet["lr"]) <= 1e-6
    off, n = _bf16_ulps_off(tnew, jax.tree_util.tree_leaves(jnew))
    assert off < BF16_PARAMS_OFF * n, f"{off} of {n} new params off by more than one bf16 ulp"
    assert all(t.dtype == torch.float32 for t in tree_leaves([topt["mu"], topt["nu"]]))
    _close_trees(topt["mu"], jopt["mu"], 2e-2)
    _close_trees(topt["nu"], jopt["nu"], 4e-2)
    port_off, _ = _bf16_ulps_off(tnew, jax.tree_util.tree_leaves(fnew), strict_f32=False)
    ref_off, _ = _bf16_ulps_off(_carry(jnew), jax.tree_util.tree_leaves(fnew), strict_f32=False)
    assert port_off <= 1.25 * ref_off, (port_off, ref_off)
    for key in ("mu", "nu"):
        f = jax.tree_util.tree_leaves(fopt[key])
        port, ref = (_max_drift(tree_leaves(topt[key]), f),
                     _max_drift(jax.tree_util.tree_leaves(jopt[key]), f))
        assert port <= 1.25 * ref, f"{key}: {port:.3e} from the f32 step vs JAX's {ref:.3e}"


def test_bf16_adamw_update_matches_jax():
    """Two updates of bf16 params from the same bf16 grads in both packages:
    fewer than 0.1% of the new params may differ by more than one bf16 ulp
    (f32 arithmetic in another order can round across a bf16 boundary).  The
    clipped grads are rounded back to bf16 and the two global norms differ
    in their last f32 digit, so a clipped grad can land one bf16 ulp away:
    mu holds to 2^-8 (one bf16 ulp) of its leaf's max, nu (squares) to 2^-7."""
    jcfg, _, jp, tp = _model(dtype="bfloat16")
    jcfg_opt, tcfg_opt = JA.AdamWConfig(**OPT), TA.AdamWConfig(**OPT)
    jopt, topt = JA.adamw_init(jp), TA.adamw_init(tp)
    rng = np.random.default_rng(9)
    for _ in range(2):
        grads = jax.tree_util.tree_map(
            lambda x: (rng.standard_normal(x.shape) * 0.05).astype(jnp.bfloat16), jp)
        jp, jopt, jm = JA.adamw_update(jax.tree_util.tree_map(jnp.asarray, grads), jopt, jp,
                                       jcfg_opt)
        with torch.no_grad():
            tp, topt, tm = TA.adamw_update(_carry(grads), topt, tp, tcfg_opt)
        assert _rel(tm["grad_norm"], jm["grad_norm"]) <= 1e-5
        assert _rel(tm["lr"], jm["lr"]) <= 1e-6
    off, n = _bf16_ulps_off(tp, jax.tree_util.tree_leaves(jp))
    assert off < 1e-3 * n, f"{off} of {n} new params off by more than one bf16 ulp"
    _close_trees(topt["mu"], jopt["mu"], 2 ** -8)
    _close_trees(topt["nu"], jopt["nu"], 2 ** -7)
    assert int(topt["step"]) == int(jopt["step"]) == 2


def test_three_steps_losses_match_jax():
    jcfg, tcfg, jp, tp = _model()
    jds = JD.SyntheticDataset(JD.DataConfig(jcfg.vocab, 16, 2, seed=0))
    tds = TD.SyntheticDataset(TD.DataConfig(tcfg.vocab, 16, 2, seed=0))
    jstep = _jax_step(jcfg, JA.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=3))
    tstep = make_train_step(tcfg, None, TC.ShapeConfig("t", 16, 2, "train"),
                            TA.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=3),
                            remat=False).fn
    jopt, topt = JA.adamw_init(jp), TA.adamw_init(tp)
    jl, tl = [], []
    for s in range(3):
        jp, jopt, jm = jstep(jp, jopt, _jb(jds.batch(s)))
        tp, topt, tm = tstep(tp, topt, _tb(tds.batch(s)))
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    _close(np.asarray(tl), np.asarray(jl))


def test_every_leaf_moves_in_one_step():
    """Every param gets a gradient and an update (no leaf is left behind)."""
    _, tcfg = _cfgs()
    _, params = init_model(tcfg, device="cpu")
    before = [t.clone() for t in tree_leaves(params)]
    params, opt, _ = make_train_step(tcfg, None, TC.ShapeConfig("t", 16, 2, "train"), TA.AdamWConfig(**OPT)).fn(
        params, TA.adamw_init(params), _tb(_batch(tcfg.vocab, seed=4)))
    for (path, t), b in zip(tree_paths(params), before):
        assert not torch.equal(t, b), path
        assert t.grad is None, path
    assert all(t.abs().sum() > 0 for t in tree_leaves(opt["mu"]))


def test_a_param_without_a_gradient_raises():
    _, tcfg = _cfgs()
    _, params = init_model(tcfg, device="cpu")
    params["unused"] = torch.zeros(3)  # reaches no loss
    step = make_train_step(tcfg, None, TC.ShapeConfig("t", 16, 2, "train"), TA.AdamWConfig(**OPT)).fn
    with pytest.raises(RuntimeError, match=r"no gradient reached \[\"\['unused'\]\"\]"):
        step(params, TA.adamw_init(params), _tb(_batch(tcfg.vocab, seed=4)))


def test_remat_gives_the_same_grads():
    _, tcfg = _cfgs()
    batch = _tb(_batch(tcfg.vocab, seed=5))
    grads = []
    for remat in (False, True):
        _, params = init_model(tcfg, device="cpu")
        tree_map(lambda t: t.requires_grad_(True), params)
        total, _ = TTF.forward_train(params, tcfg, batch, remat=remat)
        total.backward()
        grads.append([t.grad for t in tree_leaves(params)])
    for (path, _), g0, g1 in zip(tree_paths(params), *grads):
        _close(g1, g0, what=path)


# -- schedule and clip -------------------------------------------------------------


@pytest.mark.parametrize("steps", [[0, 1, 37, 99, 100],  # warmup
                                   [101, 2500, 5000, 9999],  # decay
                                   [10_000, 10_001, 50_000]])  # past total_steps
def test_cosine_schedule_matches_jax(steps):
    for s in steps:
        want = float(JA.cosine_schedule(JA.AdamWConfig(), jnp.asarray(s, jnp.int32)))
        got = TA.cosine_schedule(TA.AdamWConfig(), torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert abs(float(got) - want) <= 1e-6 * max(abs(want), 1e-12), (s, float(got), want)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])  # above the threshold, below it
def test_clip_by_global_norm_matches_jax(max_norm):
    rng = np.random.default_rng(6)
    tree = {"a": rng.standard_normal((5, 7)).astype(np.float32),
            "b": {"c": rng.standard_normal(11).astype(np.float32),
                  "d": rng.standard_normal((3, 4)).astype(jnp.bfloat16)}}
    jt, jg = JA.clip_by_global_norm(jax.tree_util.tree_map(jnp.asarray, tree), max_norm)
    tt, tg = TA.clip_by_global_norm(params_from_numpy(tree, "cpu"), max_norm)
    assert _rel(tg, jg) <= 1e-6
    assert (float(jg) > max_norm) == (max_norm == 0.5)
    for g, w in zip(tree_leaves(tt), jax.tree_util.tree_leaves(jt)):
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        _close(g, w, 1e-6 if g.dtype == torch.float32 else 2 ** -8)


# -- data ----------------------------------------------------------------------------


@pytest.mark.parametrize("task", ["affine", "uniform"])
@pytest.mark.parametrize("seed,step,shard,n_shards", [(0, 0, 0, 1), (3, 17, 1, 2),
                                                      (11, 5, 3, 4)])
def test_synthetic_batches_match_jax_bit_for_bit(task, seed, step, shard, n_shards):
    jds = JD.SyntheticDataset(JD.DataConfig(1000, 24, 8, task=task, seed=seed))
    tds = TD.SyntheticDataset(TD.DataConfig(1000, 24, 8, task=task, seed=seed))
    want, got = jds.batch(step, shard, n_shards), tds.batch(step, shard, n_shards)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


# -- checkpoints ---------------------------------------------------------------------


def _jax_state(dtype):
    jcfg, tcfg, jp, tp = _model(dtype=dtype)
    return jcfg, tcfg, {"params": jp, "opt": JA.adamw_init(jp)}, \
        {"params": tp, "opt": TA.adamw_init(tp)}


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16).astype(np.int16) if a.dtype == jnp.bfloat16 else a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_cross_loads_bit_for_bit(tmp_path, writer, dtype):
    _, _, jstate, tstate = _jax_state(dtype)
    # different values on the reading side, so a restore that did nothing fails
    tstate["opt"]["step"] += 3
    jstate = dict(jstate, opt=dict(jstate["opt"], step=jnp.asarray(3, jnp.int32)))
    jm = JCheckpointManager(JObjectStore(root=str(tmp_path)), "ckpt", "run")
    tm = CheckpointManager(ObjectStore(root=str(tmp_path)), "ckpt", "run")
    if writer == "jax":
        jm.save(7, jstate, extra={"loss": 1.5})
        got, extra = tm.restore(7, tstate)
        want = jstate
    else:
        tm.save(7, tstate, extra={"loss": 1.5})
        got, extra = jm.restore(7, jstate)
        want = tstate
    assert extra == {"loss": 1.5}
    assert tm.latest_step() == jm.latest_step() == 7
    got_leaves = tree_leaves(got) if writer == "jax" else jax.tree_util.tree_leaves(got)
    want_leaves = jax.tree_util.tree_leaves(want) if writer == "jax" else tree_leaves(want)
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    # the manifest each package writes lists the same paths, dtypes and shapes
    manifests = []
    for mgr, state, step in ((jm, jstate, 8), (tm, tstate, 9)):
        mgr.save(step, state)
        raw = json.loads((tmp_path / "ckpt" / "run" / f"step_{step:08d}" /
                          "MANIFEST.json").read_text())
        manifests.append([(e["path"], e["dtype"], e["shape"]) for e in raw["leaves"]])
    assert manifests[0] == manifests[1]
    assert ("['opt']['step']", "int32", []) in manifests[0]
    if dtype == "bfloat16":
        assert ("['params']['embed']['embedding']", "bfloat16", [256, 64]) in manifests[0]


def test_checkpoint_keeps_the_last_k_and_ignores_uncommitted_steps():
    store = ObjectStore()  # in memory
    mgr = CheckpointManager(store, "b", "p", keep=2)
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "s": [torch.tensor(1, dtype=torch.int32)]}
    for step in (1, 2, 3):
        mgr.save_async(step, tree, extra={"at": step})
    mgr.wait()
    assert mgr.latest_step() == 3
    assert not any(k.startswith("p/step_00000001/") for k in store.list("b"))
    store.put("b", "p/step_00000009/leaf_00000.npy", b"partial")  # no MANIFEST.json
    assert mgr.latest_step() == 3
    step, got, extra = mgr.restore_latest(tree)
    assert step == 3 and extra == {"at": 3}
    assert torch.equal(got["w"], tree["w"]) and torch.equal(got["s"][0], tree["s"][0])


def test_save_async_snapshots_before_the_tree_changes():
    store = ObjectStore()
    mgr = CheckpointManager(store, "b", "p")
    w = torch.zeros(1000)
    mgr.save_async(1, {"w": w})
    w += 1.0  # the train loop updates params in place right after
    mgr.wait()
    got, _ = mgr.restore(1, {"w": w})
    assert float(got["w"].abs().max()) == 0.0


# -- the train loop and the launcher ---------------------------------------------------


def _run(tmp_path, **kw):
    _, tcfg = _cfgs()
    mgr = CheckpointManager(ObjectStore(root=str(tmp_path)), "ckpts", "runs/t1")
    return TT.train(tcfg, 10, 2, 16, mgr=mgr, ckpt_every=4, device="cpu", **kw)


def test_train_resumes_after_a_crash_with_the_same_losses(tmp_path):
    """Mirrors tests/test_e2e_training.py: a crash at step 6 with a checkpoint
    every 4 steps, then a resume from step 4 that continues the uninterrupted
    run's losses exactly."""
    full = _run(tmp_path / "full")
    with pytest.raises(RuntimeError, match="injected crash at step 6"):
        _run(tmp_path / "crashy", crash_at_step=6)
    resumed = _run(tmp_path / "crashy")
    assert full["start_step"] == 0 and resumed["start_step"] == 4
    assert resumed["state"] == full["state"] == "done" and resumed["step"] == 10
    assert resumed["history"] == full["history"][4:]
    assert resumed["final_loss"] == full["final_loss"]
    assert full["history"][-1] < full["history"][0]


def test_train_is_deterministic_and_can_be_cancelled():
    _, tcfg = _cfgs()
    runs = [TT.train(tcfg, 3, 2, 16, seed=5, device="cpu") for _ in range(2)]
    assert runs[0]["final_loss"] == runs[1]["final_loss"]
    assert len(runs[0]["history"]) == 3
    cancel = threading.Event()
    cancel.set()
    out = TT.train(tcfg, 3, 2, 16, cancel=cancel, device="cpu")
    assert out == {"state": "cancelled", "step": 0, "history": []}


def test_train_launcher_checkpoints_and_resumes(tmp_path, capsys):
    common = ["--smoke", "--device", "cpu", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
              "--batch", "2", "--seq", "16"]
    first = TT.main(common + ["--steps", "4"])
    out = capsys.readouterr().out
    assert "[train] done" in out and "resumed" not in out
    assert first["start_step"] == 0 and len(first["history"]) == 4
    second = TT.main(common + ["--steps", "6", "--json"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert "[train] resumed from step 4" in lines and "[train] done" in lines
    printed = json.loads(lines[-1])
    assert printed["start_step"] == second["start_step"] == 4
    assert printed["history"] == second["history"] and len(second["history"]) == 2


def test_moe_train_launcher_runs_on_the_cpu():
    out = TT.main(["--arch", "granite-moe-3b-a800m", "--smoke", "--device", "cpu",
                   "--steps", "2", "--batch", "2", "--seq", "16"])
    assert out["state"] == "done" and len(out["history"]) == 2
    assert all(np.isfinite(out["history"]))


def test_train_launcher_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TT.main(["--smoke", "--steps", "1"])


# -- the kernel wrappers refuse grad ----------------------------------------------------


def _wrapper_args(name):
    g = torch.Generator().manual_seed(7)
    r = lambda *s: torch.randn(*s, generator=g)
    if name == "flash_attention":
        return r(1, 8, 2, 16), r(1, 8, 1, 16), r(1, 8, 1, 16)
    if name == "decode_attention":
        return r(1, 1, 2, 16), r(1, 8, 1, 16), r(1, 8, 1, 16), torch.tensor([5], dtype=torch.int32)
    if name == "ssm_scan":
        return torch.rand(1, 6, 4, 2, generator=g), r(1, 6, 4, 2), r(1, 6, 2)
    return torch.rand(1, 6, 4, generator=g), r(1, 6, 2), r(1, 6, 2), r(1, 6, 4), -torch.rand(4, 2)


@pytest.mark.parametrize("name", sorted(kops.KERNELS))
def test_kernel_wrappers_refuse_grad(name):
    fn = kops.KERNELS[name]
    args = _wrapper_args(name)
    with torch.no_grad():
        want = fn(*(a.clone().requires_grad_(a.is_floating_point()) for a in args))
    fn(*args)  # no input requires grad
    args[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match=f"{name}: the kernel has no backward"):
        fn(*args)
    with torch.no_grad():  # grad mode off: serving's case
        got = fn(*args)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("arch,over,kernel", [
    ("gemma-2b", dict(attention_impl="pallas"), "flash_attention"),
    ("hymba-1.5b", dict(attention_impl="pallas"), "flash_attention"),
])
def test_training_refuses_the_kernel_routes(arch, over, kernel):
    """forward_train through a kernel raises under grad, and the train loop
    raises the same in step 0, before any step is taken.  The hybrid block's
    scans train without a kernel (``ssm_forward(..., train=True)``), so a
    hybrid model raises at K1 alone."""
    _, tcfg = _cfgs(arch, **over)
    _, params = init_model(tcfg, device="cpu")
    tree_map(lambda t: t.requires_grad_(True), params)
    with pytest.raises(RuntimeError, match=f"{kernel}: the kernel has no backward"):
        TTF.forward_train(params, tcfg, _tb(_batch(tcfg.vocab, seed=8)), remat=False)
    steps_taken = []
    with pytest.raises(RuntimeError, match=f"{kernel}: the kernel has no backward.*'xla'"):
        TT.train(tcfg, 2, 2, 16, device="cpu", on_step=lambda *a: steps_taken.append(a))
    assert steps_taken == []


@pytest.fixture
def scan_calls(monkeypatch):
    """Calls of the K4 and K3 wrappers, counted (on the CPU a wrapper runs
    its plain version and does not count a launch)."""
    counts = dict.fromkeys(("ssm_scan", "ssm_scan_fused"), 0)
    for name in counts:
        def counted(*args, _fn=getattr(kops, name), _name=name):
            counts[_name] += 1
            return _fn(*args)
        monkeypatch.setattr(kops, name, counted)
    return counts


def test_hybrid_chunked_scan_names_k3(scan_calls):
    """``scan_impl="chunked"`` names K3 for the prefill, once a layer, and
    training on it reaches neither scan kernel."""
    _, tcfg = _cfgs("hymba-1.5b")
    tcfg = dataclasses.replace(tcfg, ssm=dataclasses.replace(tcfg.ssm, scan_impl="chunked"))
    _, params = init_model(tcfg, device="cpu")
    batch = _tb(_batch(tcfg.vocab, seed=8))
    with torch.no_grad():
        TDEC.prefill(params, tcfg, {"tokens": batch["tokens"].long()}, max_len=16)
    assert scan_calls == {"ssm_scan": 0, "ssm_scan_fused": tcfg.n_layers}
    tree_map(lambda t: t.requires_grad_(True), params)
    total, _ = TTF.forward_train(params, tcfg, batch, remat=False)
    total.backward()
    assert scan_calls == {"ssm_scan": 0, "ssm_scan_fused": tcfg.n_layers}
    assert all(t.grad is not None for t in tree_leaves(params))


# -- hybrid training (P1): the reference's differentiable scans ---------------------


def _hybrid(scan_impl, tame=True):
    """hymba-smoke on ``scan_impl``; the chunked scan in chunks of 6, so the
    16-token batches take three chunks and two identity pad steps."""
    ssm = dict(scan_impl=scan_impl, chunk=6 if scan_impl != "assoc" else 256)
    jcfg, tcfg = _cfgs("hymba-1.5b")
    jcfg = dataclasses.replace(jcfg, ssm=dataclasses.replace(jcfg.ssm, **ssm))
    tcfg = dataclasses.replace(tcfg, ssm=dataclasses.replace(tcfg.ssm, **ssm))
    _, jp = JS.init_model(jcfg, seed=0, max_seq=16)
    if tame:
        jp = _tame(jp, jcfg)
    return jcfg, tcfg, jp, _carry(jp)


@pytest.mark.parametrize("window", [0, 6])
@pytest.mark.parametrize("scan_impl", ["assoc", "chunked"])
def test_hybrid_loss_and_grads_match_jax(scan_impl, window, scan_calls):
    """hymba-smoke: the loss and every grad leaf against ``jax.grad`` of the
    reference's ``forward_train``, with and without a sliding window of 6
    over the 16 tokens; no scan kernel is called."""
    jcfg, tcfg, jp, tp = _hybrid(scan_impl)
    batch = _batch(jcfg.vocab, seed=4)
    (jtotal, jm), jgrads = jax.value_and_grad(
        lambda p: JTF.forward_train(p, jcfg, _jb(batch), window=window, remat=False),
        has_aux=True)(jp)
    tree_map(lambda t: t.requires_grad_(True), tp)
    ttotal, tm = TTF.forward_train(tp, tcfg, _tb(batch), window=window, remat=True)
    ttotal.backward()
    assert _rel(ttotal.detach(), jtotal) <= 1e-5 and _rel(tm["loss"].detach(), jm["loss"]) <= 1e-5
    assert float(tm["aux"]) == float(jm["aux"]) == 0.0
    _close_trees(tree_map(lambda t: t.grad, tp), jgrads)
    assert scan_calls == {"ssm_scan": 0, "ssm_scan_fused": 0}


@pytest.mark.parametrize("scan_impl", ["assoc", "chunked"])
def test_hybrid_one_adamw_step_matches_jax(scan_impl):
    jcfg, tcfg, jp, tp = _hybrid(scan_impl)
    batch = _batch(jcfg.vocab, seed=3)
    jnew, jopt, jmet = _jax_step(jcfg, JA.AdamWConfig(**OPT))(jp, JA.adamw_init(jp),
                                                               _jb(batch))
    tnew, topt, tmet = make_train_step(tcfg, None, TC.ShapeConfig("t", 16, 2, "train"), TA.AdamWConfig(**OPT)).fn(
        tp, TA.adamw_init(tp), _tb(batch))
    assert _rel(tmet["loss"], jmet["loss"]) <= 1e-5
    assert _rel(tmet["grad_norm"], jmet["grad_norm"]) <= 1e-5
    _close_new_params(tnew, jnew, jopt["mu"], OPT["lr"])
    _close_trees(topt["mu"], jopt["mu"])
    _close_trees(topt["nu"], jopt["nu"])


def test_hybrid_train_launcher_trains_and_resumes(tmp_path, capsys):
    common = ["--arch", "hymba-1.5b", "--smoke", "--device", "cpu", "--ckpt-dir",
              str(tmp_path), "--ckpt-every", "2", "--batch", "2", "--seq", "16"]
    first = TT.main(common + ["--steps", "4"])
    assert first["state"] == "done" and len(first["history"]) == 4
    assert all(np.isfinite(first["history"]))
    second = TT.main(common + ["--steps", "6"])
    assert "[train] resumed from step 4" in capsys.readouterr().out
    assert second["start_step"] == 4 and len(second["history"]) == 2
    assert all(np.isfinite(second["history"]))
