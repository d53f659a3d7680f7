"""The sharded train step, ZeRO-1 and reshard-on-load on a mesh of 4 gloo
ranks on the CPU, against the JAX package's unsharded train step.

Sharding does not change JAX's result, so the JAX side runs in the test
process: the reference's ``make_train_step`` on a one-device JAX mesh, from
params it makes (wq and wk tamed, as ``tests/test_torch_train.py`` does, so
the grads are not chaotic), on batches made with numpy from a seed (B = 4,
S = 16, part of the mask off).  The port's side runs in a subprocess that
spawns 4 ranks (this file is its ``__main__``) over a ``file://``
rendezvous under the test's ``tmp_path``, each with one intra-op thread, as
``tests/test_torch_mesh_steps.py`` does; a run past ``RUN_TIMEOUT`` has its
process group killed.  Rank 0 writes the metrics of each step, the state
after each step (every param, ``mu`` and ``nu`` leaf gathered whole) and
each leaf's placements.

Each step is held against the reference's step from the same state: the
first from the shared params, each later one from the port's state before
it.  (Adam's step turns a grad near zero into a full step of either sign,
so two correct runs part after one step by ~2 lr in a few elements, and
their next grads follow: the later steps are compared from one state.)
Tolerance: the loss, aux, grad norm and lr 2e-4 relative; each ``mu`` and
``nu`` leaf 2e-4 of its max |x|, and each param leaf too but for the
elements where the grad is ~0 (``_close_state``).  The placements after the
steps equal those converted from the reference's ``p_specs`` /
``opt_pspecs`` on an abstract mesh of the same shape.

The step cases: gemma-smoke and hymba-smoke, ``tp`` and ``fsdp_tp`` on (2,
2) and ``tp`` on (1, 4), ZeRO-1 on and off, 2 steps each.  The checkpoint
run (one spawn, read by three tests): a tree saved under (2, 2) restored
under (2, 2) transposed, under (4, 1) and to one device; a ZeRO-1 state
saved on (2, 2) after 2 steps and resumed on (1, 4) for a third; and the
launcher's ``train`` crashed on (2, 2) and resumed on (1, 4), against its
unsharded run.  In this process: the launcher's mesh flags.
"""
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one intra-op thread per test worker)

ROOT = Path(__file__).resolve().parents[1]
TOL = 2e-4
B, S = 4, 16
OPT = dict(lr=1e-2, warmup_steps=1, total_steps=10)
RUN_TIMEOUT = 150  # seconds for one 4-rank run, spawn to exit
BATCH_KEYS = ("tokens", "targets", "mask")

CASES = {
    "gemma-tp-2x2-zero1": ("gemma-2b", "tp", (2, 2), True),
    "gemma-fsdp_tp-2x2": ("gemma-2b", "fsdp_tp", (2, 2), False),
    "gemma-tp-1x4-zero1": ("gemma-2b", "tp", (1, 4), True),
    "hymba-tp-2x2": ("hymba-1.5b", "tp", (2, 2), False),
    "hymba-fsdp_tp-2x2-zero1": ("hymba-1.5b", "fsdp_tp", (2, 2), True),
    "hymba-tp-1x4-zero1": ("hymba-1.5b", "tp", (1, 4), True),
}


# ---------------------------------------------------------------------------
# The ranks (run as ``python tests/test_torch_mesh_train.py <work dir>``)
# ---------------------------------------------------------------------------


def _placements(tree):
    from repro_torch.models.params import tree_paths

    return {path: [str(p) for p in t.placements] for path, t in tree_paths(tree)}


def _state(tree, prefix, arrays):
    """Every leaf of ``tree`` gathered whole into ``arrays`` under
    ``prefix`` + its path (a collective: every rank calls it)."""
    from repro_torch.models.params import tree_paths

    for path, t in tree_paths(tree):
        arrays[f"{prefix}{path}"] = t.detach().full_tensor().numpy().copy()  # not a view


def _steps(bundle, params, opt, data, mesh, first, n, out, arrays, keys=BATCH_KEYS):
    """``n`` steps of ``bundle`` from batch ``first`` on (batch i's ``keys``
    stored as "<key><i>"): the metrics go to ``out["metrics"]``, the state
    after step i (1-based) to ``arrays`` under "s<i>:params", "s<i>:mu" and
    "s<i>:nu"."""
    from repro_torch import sharding as SH

    for i in range(first, first + n):
        batch = SH.distribute({k: torch.from_numpy(data[f"{k}{i}"]) for k in keys},
                              mesh, bundle.in_shardings[2])
        params, opt, m = bundle.fn(params, opt, batch)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        for key, tree in (("params", params), ("mu", opt["mu"]), ("nu", opt["nu"])):
            _state(tree, f"s{i + 1}:{key}", arrays)
    return params, opt


def _step_job(job, data, work):
    from repro_torch import sharding as SH
    from repro_torch.configs.base import ShapeConfig, get_smoke_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import transformer as TF
    from repro_torch.models.params import params_from_numpy, tree_unflatten
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.steps import make_train_step

    mesh = make_local_mesh(*job["mesh"], device="cpu")
    cfg = get_smoke_config(job["arch"])
    bundle = make_train_step(cfg, mesh, ShapeConfig("t", S, B, "train"), AdamWConfig(**OPT),
                             job["strategy"], zero1=job["zero1"])
    leaves = [data[f"param{i}"] for i in range(job["n_params"])]
    params = params_from_numpy(tree_unflatten(TF.model_defs(cfg), leaves), "cpu", mesh,
                               bundle.in_shardings[0])
    opt = adamw_init(params, bundle.in_shardings[1])
    out = {"metrics": []}
    try:  # a batch of plain tensors is refused
        bundle.fn(params, opt, {k: torch.from_numpy(data[f"{k}0"])
                                for k in ("tokens", "targets", "mask")})
        out["refused"] = False
    except ValueError:
        out["refused"] = True
    arrays = {}
    SH.relayout.gathered_bytes = SH.relayout.reduced_bytes = 0
    params, opt = _steps(bundle, params, opt, data, mesh, 0, 2, out, arrays)
    out["gathered_bytes"], out["reduced_bytes"] = (SH.relayout.gathered_bytes,
                                                   SH.relayout.reduced_bytes)
    out["placements"] = {"params": _placements(params), "mu": _placements(opt["mu"]),
                         "nu": _placements(opt["nu"])}
    return out, arrays


def _ckpt_job(job, data, work):
    """Reshard-on-load, a ZeRO-1 resume across meshes, and the launcher's
    crash and resume across meshes."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import sharding as SH
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.base import ShapeConfig, get_smoke_config
    from repro_torch.core.objectstore import ObjectStore
    from repro_torch.launch import train as TT
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import transformer as TF
    from repro_torch.models.params import params_from_numpy, tree_unflatten
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.steps import make_train_step

    store = ObjectStore(root=str(Path(work) / "store"))
    m22 = make_local_mesh(2, 2, device="cpu")
    m14 = make_local_mesh(1, 4, device="cpu")
    m41 = init_device_mesh("cpu", (4, 1), mesh_dim_names=("data", "model"))
    out = {"reshard": {}}

    # reshard-on-load: saved under (2, 2), restored under three layouts
    tree = {"w": torch.from_numpy(data["w"]), "b": torch.from_numpy(data["b"]).bfloat16(),
            "step": torch.tensor(3, dtype=torch.int32)}
    saved = SH.distribute(tree, m22, {"w": SH.P("data", "model"), "b": SH.P("model"),
                                      "step": SH.P()})
    mgr = CheckpointManager(store, "ck", "elastic")
    mgr.save(3, saved, extra={"at": 3})
    for name, mesh, specs in (
            ("2x2-transposed", m22, {"w": SH.P("model", "data"), "b": SH.P("data"),
                                     "step": SH.P()}),
            ("4x1", m41, {"w": SH.P("data", None), "b": SH.P(None), "step": SH.P()}),
            ("one-device", None, None)):
        got, extra = mgr.restore(3, tree, shardings=specs, mesh=mesh)
        full = {k: (v.full_tensor() if mesh is not None else v) for k, v in got.items()}
        out["reshard"][name] = {
            "exact": all(torch.equal(full[k], tree[k]) for k in tree),
            "dtypes": all(full[k].dtype == tree[k].dtype for k in tree),
            "placements": (None if mesh is None else
                           {k: [str(p) for p in v.placements] for k, v in got.items()}),
            "want": (None if mesh is None else
                     {k: [str(p) for p in SH.placements(specs[k], mesh)] for k in tree}),
            "extra": extra}

    # a ZeRO-1 state saved on (2, 2) after 2 steps, resumed on (1, 4)
    cfg = get_smoke_config("gemma-2b")
    shape, opt_cfg = ShapeConfig("t", S, B, "train"), AdamWConfig(**OPT)
    b22 = make_train_step(cfg, m22, shape, opt_cfg, "tp", zero1=True)
    b14 = make_train_step(cfg, m14, shape, opt_cfg, "tp", zero1=True)
    leaves = [data[f"param{i}"] for i in range(job["n_params"])]
    params = params_from_numpy(tree_unflatten(TF.model_defs(cfg), leaves), "cpu", m22,
                               b22.in_shardings[0])
    opt = adamw_init(params, b22.in_shardings[1])
    res, arrays = {"metrics": []}, {}
    params, opt = _steps(b22, params, opt, data, m22, 0, 2, res, arrays)
    run = CheckpointManager(store, "ck", "zero1")
    run.save(2, {"params": params, "opt": opt})
    like = {"params": b14.input_specs["params"], "opt": b14.input_specs["opt_state"]}
    step, tree14, _ = run.restore_latest(
        like, shardings={"params": b14.in_shardings[0], "opt": b14.in_shardings[1]}, mesh=m14)
    res["restored_at"] = step
    params, opt = _steps(b14, tree14["params"], tree14["opt"], data, m14, 2, 1, res, arrays)
    res["placements"] = {"params": _placements(params), "mu": _placements(opt["mu"])}
    out["resume"] = res

    # the launcher: crashed at step 3 on (2, 2) under fsdp_tp, resumed on (1, 4)
    losses = {}
    launcher = CheckpointManager(store, "ck", "launcher")
    common = dict(lr=1e-2, mgr=launcher, ckpt_every=2, device="cpu",
                  on_step=lambda s, p, m: losses.__setitem__(s, m["loss"]))
    try:
        TT.train(cfg, 4, B, S, crash_at_step=3, mesh=m22, strategy="fsdp_tp", zero1=False,
                 **common)
        out["crashed"] = False
    except RuntimeError as e:
        out["crashed"] = "injected crash at step 3" in str(e)
    resumed = TT.train(cfg, 4, B, S, mesh=m14, **common)
    out["launcher"] = {"start_step": resumed["start_step"], "state": resumed["state"],
                       "losses": [losses[s] for s in sorted(losses)]}
    return out, arrays


def _rank(rank: int, work: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    job = json.loads((Path(work) / "job.json").read_text())
    data = np.load(Path(work) / "data.npz")
    dist.init_process_group("gloo", init_method=f"file://{work}/rdv", rank=rank, world_size=4)
    try:
        out, arrays = (_step_job if job["kind"] == "step" else _ckpt_job)(job, data, work)
        if rank == 0:
            np.savez(Path(work) / "got.npz", **arrays)
            (Path(work) / "result.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def _main(work: str) -> None:
    import torch.multiprocessing as mp

    mp.spawn(_rank, args=(work,), nprocs=4)


# ---------------------------------------------------------------------------
# The JAX side and the comparisons
# ---------------------------------------------------------------------------


def _tamed_params(jcfg):
    """The reference's params (seed 3) with wq and wk rescaled to std
    1/sqrt(d_model), so the attention scores are O(1)
    (``tests/test_torch_train.py::_tame``)."""
    import jax.numpy as jnp

    from repro import steps as JS

    _, jp = JS.init_model(jcfg, seed=3, max_seq=S)
    attn = dict(jp["blocks"]["attn"])
    for name, heads in (("wq", jcfg.n_heads), ("wk", jcfg.n_kv_heads)):
        w = attn[name]
        attn[name] = (w.astype(jnp.float32) * np.sqrt(heads / jcfg.d_model)).astype(w.dtype)
    return dict(jp, blocks=dict(jp["blocks"], attn=attn))


def _batches(vocab, n):
    rng = np.random.default_rng(11)
    out = {}
    for i in range(n):
        mask = np.ones((B, S), np.float32)
        mask[:, : S // 4] = 0.0
        mask[1, -3:] = 0.0
        out.update({f"tokens{i}": rng.integers(0, vocab, (B, S)).astype(np.int32),
                    f"targets{i}": rng.integers(0, vocab, (B, S)).astype(np.int32),
                    f"mask{i}": mask})
    return out


def _jax_side(arch, n_steps, work: Path, extra=None):
    """Writes the params and ``n_steps`` batches for the ranks; returns (the
    job, the JAX side: ``_held``'s arguments but the port's numbers)."""
    import jax

    from repro.configs.base import get_smoke_config

    jcfg = get_smoke_config(arch)
    jp = _tamed_params(jcfg)
    arrays = _batches(jcfg.vocab, n_steps)
    leaves = jax.tree_util.tree_leaves(jp)
    arrays.update({f"param{i}": np.asarray(leaf) for i, leaf in enumerate(leaves)})
    np.savez(work / "data.npz", **arrays, **(extra or {}))
    return {"n_params": len(leaves)}, (jcfg, jp, arrays)


def _held(jax_side, metrics, got: dict, keys=BATCH_KEYS) -> None:
    """Each of the port's steps against the reference's step from the same
    state: step 1 from the shared params, step i > 1 from the port's state
    after step i - 1 (``got``'s "s<i-1>:" arrays); batch i is its ``keys``
    stored as "<key><i>"."""
    import jax
    import jax.numpy as jnp

    from repro import steps as JS
    from repro.configs.base import ShapeConfig
    from repro.optim import adamw as JA

    jcfg, jp, arrays = jax_side
    bundle = JS.make_train_step(jcfg, jax.make_mesh((1, 1), ("data", "model")),
                                ShapeConfig("t", S, B, "train"), JA.AdamWConfig(**OPT))
    step = jax.jit(bundle.fn)
    treedef = jax.tree_util.tree_structure(jp)
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_leaves_with_path(jp)]

    def tree(prefix):
        return jax.tree_util.tree_unflatten(
            treedef, [jnp.asarray(got[f"{prefix}{path}"]) for path in paths])

    params, opt = jp, JA.adamw_init(jp)
    for i in range(len(metrics)):
        if i:
            params = tree(f"s{i}:params")
            opt = {"mu": tree(f"s{i}:mu"), "nu": tree(f"s{i}:nu"),
                   "step": jnp.asarray(i, jnp.int32)}
        batch = {k: jnp.asarray(arrays[f"{k}{i}"]) for k in keys}
        new_p, new_o, m = step(params, opt, batch)
        for k in ("loss", "aux", "grad_norm", "lr"):
            want = float(m[k])
            assert abs(metrics[i][k] - want) <= TOL * max(abs(want), 1e-12), (i, k, metrics[i])
        want = {}
        for key, t in (("params", new_p), ("mu", new_o["mu"]), ("nu", new_o["nu"])):
            for path, leaf in zip(paths, jax.tree_util.tree_leaves(t)):
                want[f"{key}{path}"] = np.asarray(leaf, np.float32)
        _close_state({k: got[f"s{i + 1}:{k}"] for k in want}, want)


def _want_placements(arch, strategy, mesh_shape, zero1, jcfg=None):
    """The reference bundle's param and opt-state specs on an abstract mesh
    of ``mesh_shape``, converted to the port's placements (as strings);
    ``jcfg`` (default: ``arch``'s smoke config) is the reference's config."""
    import jax
    from jax.sharding import AbstractMesh

    from repro import steps as JS
    from repro.configs.base import ShapeConfig, get_smoke_config
    from repro_torch import sharding as TSH

    jb = JS.make_train_step(jcfg or get_smoke_config(arch),
                            AbstractMesh(mesh_shape, ("data", "model")),
                            ShapeConfig("t", S, B, "train"), strategy=strategy, zero1=zero1)
    layout = dict(zip(("data", "model"), mesh_shape))

    def conv(tree):
        return {jax.tree_util.keystr(path): [str(p) for p in TSH.placements(TSH.P(*spec),
                                                                             layout)]
                for path, spec in jax.tree_util.tree_leaves_with_path(
                    tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))}

    p_specs, o_specs = jb.in_shardings[:2]
    return {"params": conv(p_specs), "mu": conv(o_specs["mu"]), "nu": conv(o_specs["nu"])}


def _run_ranks(work: Path, script: str = __file__) -> dict:
    """Run ``script``'s ranks on ``work`` (killed past ``RUN_TIMEOUT``);
    returns rank 0's result.json."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, script, str(work)], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=RUN_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        pytest.fail(f"the ranks did not finish in {RUN_TIMEOUT}s:\n{err[-3000:]}")
    assert proc.returncode == 0, (out + err)[-4000:]
    return json.loads((work / "result.json").read_text())


def _close_state(got: dict, want: dict) -> None:
    """Every ``mu`` and ``nu`` leaf within TOL of its max |x|, and every param
    leaf too, but for elements where f32 does not fix Adam's step
    (``tests/test_torch_train.py::_close_new_params``): where a grad is near
    zero, g / (|g| + eps) turns on its last digits, which the two packages
    (and the ranks' reductions) sum in other orders.  Such an element may
    miss TOL only if its new ``mu`` is within TOL of its leaf's max, then by
    at most the step's bound, 2 lr; such elements must be fewer than 0.1% of
    the params."""
    assert sorted(got) == sorted(want)
    n = off = 0
    for key in sorted(want):
        g, w = got[key], want[key]
        assert g.shape == w.shape, (key, g.shape, w.shape)
        d, top = np.abs(g - w), float(np.abs(w).max())
        if not key.startswith("params"):
            assert d.max() <= TOL * top, f"{key}: max err {d.max():.3e} > {TOL} x {top:.3e}"
            continue
        miss = d > TOL * top
        mu = np.abs(want["mu" + key[len("params"):]])
        assert (mu[miss] <= TOL * mu.max()).all(), f"{key}: misses TOL where the grad is not ~0"
        assert (d[miss] <= 2 * OPT["lr"]).all(), f"{key}: max err {d.max():.3e} > 2 lr"
        off += int(miss.sum())
        n += w.size
    assert off < 1e-3 * n, f"{off} of {n} new params miss TOL"


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_train_step_matches_jax(case, tmp_path):
    arch, strategy, mesh_shape, zero1 = CASES[case]
    job, jax_side = _jax_side(arch, 2, tmp_path)
    job.update(kind="step", arch=arch, strategy=strategy, mesh=list(mesh_shape), zero1=zero1)
    (tmp_path / "job.json").write_text(json.dumps(job))
    got = _run_ranks(tmp_path)
    assert got["refused"], "a batch of plain tensors was not refused"
    assert len(got["metrics"]) == 2
    _held(jax_side, got["metrics"], dict(np.load(tmp_path / "got.npz")))
    assert got["placements"] == _want_placements(arch, strategy, mesh_shape, zero1)
    if mesh_shape == (2, 2):  # the batch is split over "data": the grads are reduced
        assert got["reduced_bytes"] > 0
    if zero1 and strategy == "tp" and mesh_shape == (2, 2):  # the updated shards gathered
        assert got["gathered_bytes"] > 0


@pytest.fixture(scope="module")
def ckpt_run(tmp_path_factory):
    """One 4-rank run of ``_ckpt_job``, with the launcher's unsharded 4-step
    run beside it."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.launch import train as TT

    work = tmp_path_factory.mktemp("ckpt")
    rng = np.random.default_rng(5)
    extra = {"w": np.arange(64 * 32, dtype=np.float32).reshape(64, 32),
             "b": rng.standard_normal(8).astype(np.float32)}
    job, jax_side = _jax_side("gemma-2b", 3, work, extra)
    job.update(kind="ckpt")
    (work / "job.json").write_text(json.dumps(job))
    got = _run_ranks(work)
    plain = TT.train(get_smoke_config("gemma-2b"), 4, B, S, lr=1e-2, device="cpu")
    return got, dict(np.load(work / "got.npz")), jax_side, plain


def test_checkpoint_reshard_on_load(ckpt_run):
    """Saved under (2, 2) with P("data", "model"); restored under (2, 2) with
    P("model", "data"), under (4, 1) with P("data", None), and with
    ``shardings=None``: the values exact, each placed as asked."""
    got = ckpt_run[0]["reshard"]
    assert sorted(got) == ["2x2-transposed", "4x1", "one-device"]
    for name, r in got.items():
        assert r["exact"] and r["dtypes"] and r["extra"] == {"at": 3}, name
        assert r["placements"] == r["want"], name
    assert got["2x2-transposed"]["placements"]["w"] == ["S(1)", "S(0)"]
    assert got["4x1"]["placements"]["w"] == ["S(0)", "R"]


def test_zero1_state_resumes_on_another_mesh(ckpt_run):
    """A ZeRO-1 state saved on (2, 2) after 2 steps and resumed on (1, 4)
    for a third: each step within TOL of the reference's, the third placed
    by the (1, 4) bundle's specs."""
    got, arrays, jax_side, _ = ckpt_run
    res = got["resume"]
    assert res["restored_at"] == 2 and len(res["metrics"]) == 3
    _held(jax_side, res["metrics"], arrays)
    placed = _want_placements("gemma-2b", "tp", (1, 4), True)
    assert res["placements"] == {"params": placed["params"], "mu": placed["mu"]}


def test_train_launcher_crashes_and_resumes_across_meshes(ckpt_run):
    """``train(..., mesh=)`` under fsdp_tp on (2, 2), crashed at step 3 after
    the checkpoint of step 2, resumed under tp on (1, 4): its 4 losses are
    within TOL of the unsharded ``train``'s."""
    got, plain = ckpt_run[0], ckpt_run[3]
    assert got["crashed"]
    assert got["launcher"]["start_step"] == 2 and got["launcher"]["state"] == "done"
    losses = got["launcher"]["losses"]
    assert len(losses) == len(plain["history"]) == 4
    for g, w in zip(losses, plain["history"]):
        assert abs(g - w) <= TOL * abs(w), (losses, plain["history"])


def test_train_launcher_mesh_flags_need_torchrun(monkeypatch):
    from repro_torch.launch import train as TT

    for key in TT.TORCHRUN_ENV:
        monkeypatch.delenv(key, raising=False)
    argv = ["--smoke", "--device", "cpu", "--steps", "1", "--data", "2", "--model", "2"]
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 4"):
        TT.main(argv)
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "1")
    with pytest.raises(RuntimeError, match="needs 4 ranks, torchrun started 2"):
        TT.main(argv)


def test_train_launcher_at_one_by_one_has_no_mesh():
    """--strategy and --no-zero1 at 1 x 1 run the one-device step
    (``mesh=None``): the same losses as without them."""
    from repro_torch.launch import train as TT

    common = ["--smoke", "--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "16"]
    plain = TT.main(common)
    flagged = TT.main(common + ["--strategy", "fsdp_tp", "--no-zero1"])
    assert flagged["history"] == plain["history"] and len(plain["history"]) == 2


if __name__ == "__main__":
    _main(sys.argv[1])
