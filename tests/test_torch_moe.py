"""The port's mixture-of-experts layer (``repro_torch.models.moe``) against the
JAX package's (``repro.models.moe``), on the CPU.

Inputs are made with numpy from a seed and handed to both packages; params
are made by the JAX package and carried over with ``params_from_numpy``.
``torch.topk`` and ``jax.lax.top_k`` may order exact ties differently, so
every case first asserts that no token has a near-tie at its k-th choice.
Tolerances: 2e-5 in f32 and 2e-2 in bf16 (``tests/test_kernels.py::_tol``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as JC
from repro.models import moe as JMOE
from repro.models import params as JP
from repro_torch.configs import base as TC
from repro_torch.models import moe as TMOE
from repro_torch.models import params as TP

import _torch_threads  # noqa: F401  (one intra-op thread per test worker)

TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
MIN_GAP = 1e-4  # least logit gap between a token's k-th and (k+1)-th expert
j_router = jax.jit(JMOE._router, static_argnames=("cfg",))
j_dense = jax.jit(JMOE.moe_dense, static_argnames=("cfg",))
j_dropping = jax.jit(JMOE.moe_dropping, static_argnames=("cfg",))
j_apply = jax.jit(JMOE.apply_moe, static_argnames=("cfg",))


def _cfgs(arch="granite-moe-3b-a800m", moe=None, **kw):
    """Both packages' smoke configs of ``arch``; ``moe`` overrides fields of
    its MoEConfig (the default: 8 experts, top-2, width 32)."""
    moe = dict(dict(n_experts=8, top_k=2, d_ff_expert=32), **(moe or {}))
    out = []
    for base in (JC, TC):
        cfg = base.get_smoke_config(arch, **kw)
        out.append(dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe)))
    return out


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, dtype="float32"):
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


def _inputs(jcfg, b, s, seed):
    """(JAX params, port params, x as a JAX array, x as a tensor)."""
    jp = JP.init_params(jax.random.PRNGKey(seed), JMOE.moe_defs(jcfg))
    tp = TP.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    x = np.random.default_rng(seed).standard_normal((b, s, jcfg.d_model), np.float32)
    jx = jnp.asarray(x).astype(jnp.dtype(jcfg.dtype))
    return jp, tp, jx, torch.from_numpy(_np(jx).copy()).to(getattr(torch, jcfg.dtype))


def _assert_no_near_ties(jp, jx, k):
    """Every token's k-th and (k+1)-th router logits differ by > MIN_GAP, so
    both packages' top-k pick the same experts."""
    logits = np.sort(np.asarray(jx.astype(jnp.float32) @ jp["router"]), axis=-1)[..., ::-1]
    gap = logits[..., k - 1] - logits[..., k]
    assert gap.min() > MIN_GAP, f"near-tie at the k-th choice: gap {gap.min():.2e}"


def _jax_kept(idx, jcfg, s):
    """The reference's kept (group, token, expert) triples, from its idx by
    its own lines (``repro/models/moe.py``, ``moe_dropping``: the capacity,
    the exclusive cumsum over the token-major pairs, ``pos < capacity``)."""
    m = jcfg.moe
    b = idx.shape[0]
    capacity = max(int(s * m.top_k * m.capacity_factor / m.n_experts), 1)
    capacity = (capacity + 7) // 8 * 8
    onehot = jax.nn.one_hot(idx, m.e_pad, dtype=jnp.int32)
    flat = onehot.reshape(b, s * m.top_k, m.e_pad)
    pos = jnp.sum(flat * (jnp.cumsum(flat, axis=1) - flat), axis=-1).reshape(b, s, m.top_k)
    keep = np.asarray(pos < capacity)
    idx = np.asarray(idx)
    return {(bi, si, int(idx[bi, si, j])) for bi, si, j in zip(*np.nonzero(keep))}


def _port_kept(idx, tcfg, s):
    _, keep = TMOE.queue_slots(idx, TMOE.capacity(s, tcfg.moe), tcfg.moe.e_pad)
    return {(bi, si, int(idx[bi, si, j])) for bi, si, j in zip(*np.nonzero(keep.numpy()))}


def test_router_matches_jax():
    jcfg, tcfg = _cfgs()
    jp, tp, jx, tx = _inputs(jcfg, 2, 24, seed=0)
    _assert_no_near_ties(jp, jx, jcfg.moe.top_k)
    jprobs, jgates, jidx = j_router(jp, jx, cfg=jcfg)
    probs, gates, idx = TMOE._router(tp, tx, tcfg)
    assert probs.dtype == gates.dtype == torch.float32
    _close(probs, jprobs)
    _close(gates, jgates)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_aux_load_balance_loss_matches_jax():
    """The assignment is one-hot over the real experts, not the padded count."""
    rng = np.random.default_rng(1)
    probs = rng.dirichlet(np.ones(6), size=(3, 10)).astype(np.float32)
    idx = np.argsort(-probs, axis=-1)[..., :2].astype(np.int32)
    want = JMOE.aux_load_balance_loss(jnp.asarray(probs), jnp.asarray(idx), 6)
    got = TMOE.aux_load_balance_loss(torch.from_numpy(probs), torch.from_numpy(idx).long(), 6)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
def test_moe_dense_matches_jax(activation):
    jcfg, tcfg = _cfgs(moe=dict(routing_impl="dense"), activation=activation)
    jp, tp, jx, tx = _inputs(jcfg, 2, 12, seed=2)
    _assert_no_near_ties(jp, jx, jcfg.moe.top_k)
    jout, jaux = j_dense(jp, jx, cfg=jcfg)
    out, aux = TMOE.moe_dense(tp, tx, tcfg)
    assert out.dtype == tx.dtype
    _close(out, jout)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


# (label, B, S, MoEConfig fields, dtype): capacity >= S never binds; 0.5
# binds (capacity 8 for a mean load of 16); three groups; 12 padded experts
# (4 of them never routed to); the loose case in bf16
DROPPING = [
    ("loose", 2, 16, dict(capacity_factor=4.0), "float32"),
    ("binding", 2, 64, dict(capacity_factor=0.5), "float32"),
    ("groups", 3, 40, dict(capacity_factor=1.0), "float32"),
    ("padded", 2, 32, dict(n_experts_padded=12, capacity_factor=1.0), "float32"),
    ("bf16", 2, 16, dict(capacity_factor=4.0), "bfloat16"),
]


@pytest.mark.parametrize("label,b,s,moe,dtype", DROPPING, ids=[d[0] for d in DROPPING])
def test_moe_dropping_matches_jax(label, b, s, moe, dtype):
    jcfg, tcfg = _cfgs(moe=dict(moe, routing_impl="dropping"), dtype=dtype)
    jp, tp, jx, tx = _inputs(jcfg, b, s, seed=3 + b + s)
    _assert_no_near_ties(jp, jx, jcfg.moe.top_k)
    jout, jaux = j_dropping(jp, jx, cfg=jcfg)
    out, aux = TMOE.moe_dropping(tp, tx, tcfg)
    assert out.dtype == tx.dtype and tuple(out.shape) == (b, s, jcfg.d_model)
    _close(out, jout, dtype)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    # the same (group, token, expert) pairs are kept
    _, _, jidx = j_router(jp, jx, cfg=jcfg)
    _, _, idx = TMOE._router(tp, tx, tcfg)
    kept, pairs = _port_kept(idx, tcfg, s), b * s * jcfg.moe.top_k
    assert kept == _jax_kept(jidx, jcfg, s)
    if label == "binding":
        assert len(kept) < 0.75 * pairs  # capacity 8 of a mean load of 16
    elif label in ("loose", "bf16"):
        assert len(kept) == pairs
    if label == "padded":
        assert max(e for _, _, e in kept) < jcfg.moe.n_experts


def test_moe_dropping_drops_later_tokens_first():
    """Within a group an expert's queue is in token order: with every token
    routed to the same two experts, exactly the first ``capacity`` tokens
    are kept, and a dropped token's output is zero."""
    _, tcfg = _cfgs(moe=dict(capacity_factor=0.5))
    m = tcfg.moe
    s = 64
    c = TMOE.capacity(s, m)
    idx = torch.tensor([[[3, 5]] * s, [[5, 3]] * s])
    _, keep = TMOE.queue_slots(idx, c, m.e_pad)
    want = torch.arange(s)[None, :, None].expand(2, s, 2) < c
    assert c == 8 and torch.equal(keep, want)
    p = TP.init_params(TMOE.moe_defs(tcfg), torch.Generator().manual_seed(0))
    p["router"] = torch.zeros_like(p["router"])
    p["router"][:, 3] = p["router"][:, 5] = 1.0  # experts 3 and 5 beat the rest
    x = torch.rand(1, s, tcfg.d_model) + 0.5
    out, _ = TMOE.moe_dropping(p, x, tcfg)
    assert bool(out[0, :c].abs().sum(-1).gt(0).all()) and not bool(out[0, c:].any())


def test_shared_experts_match_jax():
    """moonshot's smoke config with two shared experts: one MLP of width
    2 x d_ff_expert, added to the routed experts' output."""
    jcfg, tcfg = _cfgs("moonshot-v1-16b-a3b", moe=dict(n_shared_experts=2))
    assert set(JMOE.moe_defs(jcfg)) == set(TMOE.moe_defs(tcfg)) == {"router", "w1", "w2", "w3",
                                                                    "shared"}
    jp, tp, jx, tx = _inputs(jcfg, 2, 16, seed=4)
    assert tuple(tp["shared"]["w1"].shape) == (jcfg.d_model, 2 * jcfg.moe.d_ff_expert)
    _assert_no_near_ties(jp, jx, jcfg.moe.top_k)
    jout, jaux = j_apply(jp, jx, cfg=jcfg)
    out, aux = TMOE.apply_moe(tp, tx, tcfg)
    _close(out, jout)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    routed, _ = TMOE.moe_dropping(tp, tx, tcfg)
    assert float((out - routed).abs().max()) > 0.1  # the shared experts add to it


@pytest.mark.parametrize("impl", ["ep_shard_map", "ep_gather"])
def test_expert_parallel_impls_raise(impl):
    """With no ``ep_mesh`` installed both expert-parallel routes raise the
    reference's ``RuntimeError`` (``repro/parallel/ep.py``): there is no
    fallback to ``"dropping"``.  ``tests/test_torch_parallel.py`` runs them
    on a mesh."""
    _, tcfg = _cfgs(moe=dict(routing_impl=impl))
    p = TP.init_params(TMOE.moe_defs(tcfg), torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match=f"{impl} requires ep_mesh"):
        TMOE.apply_moe(p, torch.zeros(1, 4, tcfg.d_model), tcfg)
