"""Expert parallelism, the pipeline and int8 gradient compression of the
port (``repro_torch.parallel.ep``, ``parallel.pipeline``,
``optim.compression``) on 4 gloo ranks on the CPU, against the JAX
package's same functions on 4 forced host devices.

Both sides run once for the whole file (the ``runs`` fixture), each in a
subprocess that this file is the ``__main__`` of:

- ``python tests/test_torch_parallel.py ref <dir>``: the reference, with
  ``XLA_FLAGS=--xla_force_host_platform_device_count=4`` and
  ``JAX_PLATFORMS=cpu`` (as ``tests/test_parallel.py`` runs
  ``tools/parallel_checks.py``), makes every input from a numpy seed (the
  params with its own ``init_params``), runs its functions on meshes of 4
  devices and writes ``ref.npz``;
- ``python tests/test_torch_parallel.py ranks <dir>``: 4 spawned gloo ranks
  over a ``file://`` rendezvous read ``ref.npz``, carry the params with
  ``params_from_numpy``, run the port's functions, and rank 0 writes
  ``got.npz`` and ``result.json``.  Past ``RUN_TIMEOUT`` the process group
  is killed.

The cases:

- EP: granite-moe-smoke and moonshot-smoke (a shared expert) under both
  routes on (2, 2) and (1, 4), and granite-moe-smoke with 6 experts padded
  to 8 on (1, 4), whose last rank holds only pads: the output, aux, the
  grads of ``out.sum()`` with respect to x, the router and every expert
  weight, and the grads of aux with respect to x and the router, within
  2e-4 (f32) of the reference's same route on the same mesh shape; the
  port's EP output equals the port's ``"dropping"``, and its aux the mean
  of the dp groups' ``"dropping"`` aux, as
  ``tools/parallel_checks.py::check_ep_matches_dropping`` asserts of the
  reference.  granite-moe-smoke under ``ep_gather`` on (2, 2) through the
  step bundles: a prefill and 2 decode steps, and one train step, against
  the reference's bundles on the same mesh.
- Pipeline: the reference's check (d = 16, L = 8, b = 8, tanh layers, 4
  stages) with ``n_micro`` 2, 4 and 8: the forward and the grads of
  ``sum(out * ct)`` with respect to x and the stage weights within 1e-5.
- Compression: ``compressed_mean`` and ``compressed_mean_tree`` (a size
  the ranks do not divide, a carried error): every rank's mean identical,
  the mean and each rank's new error within 1e-6 of the reference's, the
  mean within the reference's bound 2 amax / 127 of the exact mean, and
  every tensor on the wire int8 but for the 4-byte scales.

In this process: ``quantize_int8`` and its neighbours against JAX (the
int8 values identical, ties at .5 included), the refusals, and
``stack_stage_params``.
"""
import dataclasses
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
B, S = 4, 16  # the MoE layer's input and the bundles' train batch
PROMPT, MAX_LEN, STEPS = 16, 24, 2
RUN_TIMEOUT = 240  # seconds for each side's subprocess, start to exit
MIN_GAP = 1e-4  # least router-logit gap at a token's k-th choice

GRANITE, MOONSHOT = "granite-moe-3b-a800m", "moonshot-v1-16b-a3b"
EP_CASES = {f"{name}-{route}-{m[0]}x{m[1]}": (arch, route, m, {})
            for name, arch in (("granite", GRANITE), ("moonshot", MOONSHOT))
            for route in ("ep_gather", "ep_shard_map") for m in ((2, 2), (1, 4))}
EP_CASES.update({f"granite6of8-{route}-1x4": (GRANITE, route, (1, 4),
                                              {"n_experts": 6, "n_experts_padded": 8})
                 for route in ("ep_gather", "ep_shard_map")})
EXPERT_KEYS = ("router", "w1", "w2", "w3")
PIPE = dict(d=16, layers=8, b=8, stages=4)
N_MICRO = (2, 4, 8)
COMP_SHAPE = (5, 13)  # 65 elements: padded to 68 over 4 ranks


def _cfg(get_smoke_config, arch, route, over):
    """``arch``'s smoke config (either package's) routed by ``route``, its
    MoE config's fields replaced by ``over``."""
    cfg = get_smoke_config(arch)
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, routing_impl=route,
                                                            **over))


def _flat(tree, prefix, out):
    """The leaves of a nested dict of arrays into ``out`` as "prefix/a/b"."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _flat(v, f"{prefix}/{k}", out)
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def _nest(data, prefix):
    """``_flat``'s inverse for the keys under ``prefix``."""
    tree = {}
    for key in data:
        if key.startswith(prefix + "/"):
            *path, leaf = key[len(prefix) + 1:].split("/")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    return tree


# ---------------------------------------------------------------------------
# The reference (run as ``python tests/test_torch_parallel.py ref <dir>``)
# ---------------------------------------------------------------------------


def _reference(work: Path) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, PartitionSpec as P

    from repro import steps as JS
    from repro.compat import shard_map
    from repro.configs.base import ShapeConfig, get_smoke_config
    from repro.models import moe as JMOE
    from repro.models.params import init_params
    from repro.optim import adamw as JA
    from repro.optim import compression as JC
    from repro.parallel.ep import ep_mesh
    from repro.parallel.pipeline import pipeline_apply, stack_stage_params
    from test_torch_mesh_train import OPT, _batches, _tamed_params

    assert len(jax.devices()) == 4, jax.devices()

    def make_mesh(shape, names):  # GSPMD's meshes (JAX's newer default is Explicit)
        return jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(shape))

    arrays = {}
    for i, (case, (arch, route, shape, over)) in enumerate(EP_CASES.items()):
        cfg = _cfg(get_smoke_config, arch, route, over)
        p = init_params(jax.random.PRNGKey(10 + i), JMOE.moe_defs(cfg))
        x = np.random.default_rng(20 + i).standard_normal((B, S, cfg.d_model), np.float32)
        logits = np.sort(x @ np.asarray(p["router"]), axis=-1)[..., ::-1]
        arrays[f"{case}:gap"] = np.asarray((logits[..., cfg.moe.top_k - 1]
                                            - logits[..., cfg.moe.top_k]).min())
        mesh = make_mesh(shape, ("data", "model"))

        def out_sum(p, x):
            return JMOE.apply_moe(p, x, cfg)[0].sum()

        with ep_mesh(mesh):
            out, aux = jax.jit(lambda p, x: JMOE.apply_moe(p, x, cfg))(p, jnp.asarray(x))
            gp, gx = jax.jit(jax.grad(out_sum, argnums=(0, 1)))(p, jnp.asarray(x))
            ga, gax = jax.jit(jax.grad(lambda p, x: JMOE.apply_moe(p, x, cfg)[1],
                                       argnums=(0, 1)))(p, jnp.asarray(x))
        arrays.update({f"{case}:aux_gx": np.asarray(gax),
                       f"{case}:aux_grouter": np.asarray(ga["router"])})
        _flat(jax.tree_util.tree_map(np.asarray, p), f"{case}:p", arrays)
        arrays.update({f"{case}:x": x, f"{case}:out": np.asarray(out),
                       f"{case}:aux": np.asarray(aux), f"{case}:gx": np.asarray(gx)})
        for k in EXPERT_KEYS:
            if k in gp:
                arrays[f"{case}:g{k}"] = np.asarray(gp[k])

    # the step bundles: granite-moe-smoke under ep_gather on (2, 2)
    cfg = _cfg(get_smoke_config, GRANITE, "ep_gather", {})
    mesh = make_mesh((2, 2), ("data", "model"))
    jp = _tamed_params(cfg)
    leaves = jax.tree_util.tree_leaves(jp)
    arrays.update({f"bp{i}": np.asarray(leaf) for i, leaf in enumerate(leaves)})
    rng = np.random.default_rng(7)
    arrays["prompt"] = rng.integers(0, cfg.vocab, (B, PROMPT)).astype(np.int32)
    pre = JS.make_prefill_step(cfg, mesh, ShapeConfig("p", MAX_LEN, B, "prefill"))
    dec = JS.make_decode_step(cfg, mesh, ShapeConfig("d", MAX_LEN, B, "decode"))
    logits, cache = jax.jit(pre.fn)(jp, {"tokens": jnp.asarray(arrays["prompt"])})
    arrays["want0"] = np.asarray(logits)
    for i in range(STEPS):
        arrays[f"step{i}"] = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
        logits, cache = jax.jit(dec.fn)(jp, cache, {"tokens": jnp.asarray(arrays[f"step{i}"])})
        arrays[f"want{i + 1}"] = np.asarray(logits)
    arrays.update(_batches(cfg.vocab, 1))
    train = JS.make_train_step(cfg, mesh, ShapeConfig("t", S, B, "train"),
                               JA.AdamWConfig(**OPT), zero1=False)
    batch = {k: jnp.asarray(arrays[f"{k}0"]) for k in ("tokens", "targets", "mask")}
    new_p, new_o, m = jax.jit(train.fn)(jp, JA.adamw_init(jp), batch)
    for k in ("loss", "aux", "grad_norm", "lr"):
        arrays[f"train:{k}"] = np.asarray(m[k])
    for key, t in (("params", new_p), ("mu", new_o["mu"]), ("nu", new_o["nu"])):
        for path, leaf in jax.tree_util.tree_leaves_with_path(t):
            arrays[f"train:{key}{jax.tree_util.keystr(path)}"] = np.asarray(leaf, np.float32)

    # the pipeline: the reference's check, with the grads
    pod = make_mesh((PIPE["stages"],), ("pod",))
    ws = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (PIPE["layers"], PIPE["d"],
                                                              PIPE["d"]), jnp.float32) * 0.2)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (PIPE["b"], PIPE["d"]), jnp.float32))
    ct = np.random.default_rng(5).standard_normal((PIPE["b"], PIPE["d"]), np.float32)
    arrays.update({"pipe:ws": ws, "pipe:x": x, "pipe:ct": ct})

    def stage_fn(params, x):
        def body(x, w):
            return jnp.tanh(x @ w), None
        return jax.lax.scan(body, x, params["w"])[0]

    for n_micro in N_MICRO:
        def run(sp, x, n_micro=n_micro):
            return pipeline_apply(stage_fn, sp, x, pod, axis="pod", n_micro=n_micro)

        sp = {"w": stack_stage_params(jnp.asarray(ws), PIPE["stages"])}
        arrays[f"pipe{n_micro}:out"] = np.asarray(jax.jit(run)(sp, jnp.asarray(x)))
        gsp, gx = jax.jit(jax.grad(lambda sp, x: jnp.sum(run(sp, x) * ct), argnums=(0, 1)))(
            sp, jnp.asarray(x))
        arrays[f"pipe{n_micro}:gw"] = np.asarray(gsp["w"]).reshape(ws.shape)
        arrays[f"pipe{n_micro}:gx"] = np.asarray(gx)

    # compression: one tensor, then a tree (one leaf's error from init_error_tree)
    dp = make_mesh((4,), ("dp",))
    rng = np.random.default_rng(3)
    xs = rng.standard_normal((4,) + COMP_SHAPE).astype(np.float32)
    errs = (rng.standard_normal((4,) + COMP_SHAPE) * 0.01).astype(np.float32)
    ys = rng.standard_normal((4, 7)).astype(np.float32)
    arrays.update({"comp:x": xs, "comp:err": errs, "comp:y": ys})

    def one(x, e):
        mean, new_err = JC.compressed_mean(x[0], e[0], "dp")
        return mean[None], new_err[None]

    def tree(x, e, y):
        grads = {"a": x[0], "b": [y[0]]}
        errors = {"a": e[0], "b": JC.init_error_tree([y[0]])}
        means, new = JC.compressed_mean_tree(grads, errors, "dp")
        return means["a"][None], means["b"][0][None], new["a"][None], new["b"][0][None]

    mean, new_err = jax.jit(shard_map(one, dp, in_specs=(P("dp"), P("dp")),
                                      out_specs=(P("dp"), P("dp")), check_vma=False))(xs, errs)
    arrays.update({"comp:mean": np.asarray(mean), "comp:new_err": np.asarray(new_err)})
    got = jax.jit(shard_map(tree, dp, in_specs=(P("dp"),) * 3, out_specs=(P("dp"),) * 4,
                            check_vma=False))(xs, errs, ys)
    for name, a in zip(("tmean_a", "tmean_b", "tnew_a", "tnew_b"), got):
        arrays[f"comp:{name}"] = np.asarray(a)
    np.savez(work / "ref.npz", **arrays)


# ---------------------------------------------------------------------------
# The ranks (run as ``python tests/test_torch_parallel.py ranks <dir>``)
# ---------------------------------------------------------------------------


def _ep_rank(case, mesh, data, arrays):
    from repro_torch import sharding as SH
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import moe as MOE
    from repro_torch.models.params import params_from_numpy
    from repro_torch.parallel.ep import ep_mesh

    arch, route, _, over = EP_CASES[case]
    cfg = _cfg(get_smoke_config, arch, route, over)
    tree = _nest(data, f"{case}:p")
    specs = SH.param_pspecs(MOE.moe_defs(cfg), SH.make_rules(mesh), mesh)
    p = SH.tree_map(lambda t: t.requires_grad_(), params_from_numpy(tree, "cpu", mesh, specs))
    x = SH.distribute({"x": torch.from_numpy(data[f"{case}:x"])}, mesh,
                      {"x": SH.P("data", None, None)})["x"].requires_grad_()
    with ep_mesh(mesh):
        out, aux = MOE.apply_moe(p, x, cfg)
    full = out.full_tensor()
    aux_gx, aux_grouter = torch.autograd.grad(aux.full_tensor(), [x, p["router"]],
                                              retain_graph=True)
    full.sum().backward()
    arrays.update({f"{case}:out": full.detach().numpy(),
                   f"{case}:aux": aux.full_tensor().detach().numpy(),
                   f"{case}:gx": x.grad.full_tensor().numpy(),
                   f"{case}:aux_gx": aux_gx.full_tensor().numpy(),
                   f"{case}:aux_grouter": aux_grouter.full_tensor().numpy()})
    for k in EXPERT_KEYS:
        if k in p:
            arrays[f"{case}:g{k}"] = p[k].grad.full_tensor().numpy()
    # the port's own "dropping" on the whole batch, and its aux by dp group
    drop = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, routing_impl="dropping"))
    plain = params_from_numpy(tree, "cpu")
    xs = torch.from_numpy(data[f"{case}:x"])
    with torch.no_grad():
        arrays[f"{case}:drop_out"] = MOE.apply_moe(plain, xs, drop)[0].numpy()
        n = mesh.size(0)
        rows = xs.shape[0] // n
        arrays[f"{case}:drop_aux"] = np.mean([float(MOE.apply_moe(
            plain, xs[i * rows:(i + 1) * rows], drop)[1]) for i in range(n)])


def _bundles_rank(mesh, data, arrays, out):
    from repro_torch import sharding as SH
    from repro_torch.configs.base import ShapeConfig, get_smoke_config
    from repro_torch.models import transformer as TF
    from repro_torch.models.params import params_from_numpy, tree_leaves, tree_unflatten
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.steps import make_decode_step, make_prefill_step, make_train_step
    from test_torch_mesh_train import OPT, _steps

    cfg = _cfg(get_smoke_config, GRANITE, "ep_gather", {})
    defs = TF.model_defs(cfg, max_seq=S)
    leaves = [data[f"bp{i}"] for i in range(len(tree_leaves(defs)))]
    pre = make_prefill_step(cfg, mesh, ShapeConfig("p", MAX_LEN, B, "prefill"))
    dec = make_decode_step(cfg, mesh, ShapeConfig("d", MAX_LEN, B, "decode"))
    params = params_from_numpy(tree_unflatten(defs, leaves), "cpu", mesh, pre.in_shardings[0])

    def place(tokens, specs):
        return SH.distribute({"tokens": torch.from_numpy(tokens)}, mesh, specs)

    logits, cache = pre.fn(params, place(data["prompt"], pre.in_shardings[1]))
    arrays["logits0"] = logits.numpy()
    for i in range(STEPS):
        logits, cache = dec.fn(params, cache, place(data[f"step{i}"], dec.in_shardings[2]))
        arrays[f"logits{i + 1}"] = logits.numpy()
    train = make_train_step(cfg, mesh, ShapeConfig("t", S, B, "train"), AdamWConfig(**OPT),
                            "tp", zero1=False)
    params = params_from_numpy(tree_unflatten(defs, leaves), "cpu", mesh,
                               train.in_shardings[0])
    opt = adamw_init(params, train.in_shardings[1])
    out["train"] = []
    state = {}
    _steps(train, params, opt, data, mesh, 0, 1, {"metrics": out["train"]}, state)
    arrays.update({f"train:{k[3:]}": v for k, v in state.items()})  # "s1:params..." keys


def _pipeline_rank(data, arrays):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch import sharding as SH
    from repro_torch.parallel.pipeline import pipeline_apply, stack_stage_params

    mesh = init_device_mesh("cpu", (PIPE["stages"],), mesh_dim_names=("pod",))
    ws = stack_stage_params(torch.from_numpy(data["pipe:ws"]), PIPE["stages"])
    w = SH.distribute({"w": ws}, mesh, {"w": SH.P("pod", None, None, None)})["w"]
    w.requires_grad_()

    def rep(a):
        return DTensor.from_local(torch.from_numpy(a), mesh, [Replicate()], run_check=False)

    x, ct = rep(data["pipe:x"]).requires_grad_(), rep(data["pipe:ct"])

    def stage_fn(params, h):
        for wi in params["w"]:
            h = torch.tanh(h @ wi)
        return h

    for n_micro in N_MICRO:
        x.grad = w.grad = None
        out = pipeline_apply(stage_fn, {"w": w}, x, mesh, axis="pod", n_micro=n_micro)
        (out * ct).sum().full_tensor().backward()
        arrays[f"pipe{n_micro}:out"] = out.full_tensor().detach().numpy()
        arrays[f"pipe{n_micro}:gx"] = x.grad.full_tensor().numpy()
        arrays[f"pipe{n_micro}:gw"] = w.grad.full_tensor().numpy().reshape(data["pipe:ws"].shape)


def _compression_rank(rank, data, arrays, out):
    import torch.distributed as dist

    from repro_torch.optim import compression as C

    wire = []
    a2a, gather = dist.all_to_all_single, dist.all_gather

    def rec_a2a(output, input, *a, **k):
        wire.append(("all_to_all_single", str(input.dtype), input.numel()))
        return a2a(output, input, *a, **k)

    def rec_gather(outs, t, *a, **k):
        wire.append(("all_gather", str(t.dtype), t.numel()))
        return gather(outs, t, *a, **k)

    dist.all_to_all_single, dist.all_gather = rec_a2a, rec_gather
    try:
        x, err = torch.from_numpy(data["comp:x"][rank]), torch.from_numpy(data["comp:err"][rank])
        mean, new_err = C.compressed_mean(x, err)
        y = torch.from_numpy(data["comp:y"][rank])
        means, new = C.compressed_mean_tree({"a": x, "b": [y]},
                                            {"a": err, "b": C.init_error_tree([y])})
    finally:
        dist.all_to_all_single, dist.all_gather = a2a, gather
    mine = {"mean": mean, "new_err": new_err, "tmean_a": means["a"], "tmean_b": means["b"][0],
            "tnew_a": new["a"], "tnew_b": new["b"][0]}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, {k: v.numpy() for k, v in mine.items()})
    for k in mine:
        arrays[f"comp:{k}"] = np.stack([r[k] for r in every])
    out["wire"] = wire


def _rank(rank: int, work: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    data = dict(np.load(Path(work) / "ref.npz"))
    dist.init_process_group("gloo", init_method=f"file://{work}/rdv", rank=rank, world_size=4)
    try:
        meshes = {m: init_device_mesh("cpu", m, mesh_dim_names=("data", "model"))
                  for m in ((2, 2), (1, 4))}
        arrays, out = {}, {}
        for case, (_, _, m, _) in EP_CASES.items():
            _ep_rank(case, meshes[m], data, arrays)
        _bundles_rank(meshes[(2, 2)], data, arrays, out)
        _pipeline_rank(data, arrays)
        _compression_rank(rank, data, arrays, out)
        if rank == 0:
            np.savez(Path(work) / "got.npz", **arrays)
            (Path(work) / "result.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def _main(mode: str, work: str) -> None:
    if mode == "ref":
        _reference(Path(work))
        return
    import torch.multiprocessing as mp

    mp.spawn(_rank, args=(work,), nprocs=4)


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------


def _side(mode: str, work: Path) -> None:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]),
               OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.Popen([sys.executable, __file__, mode, str(work)], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=RUN_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        pytest.fail(f"{mode} did not finish in {RUN_TIMEOUT}s:\n{err[-3000:]}")
    assert proc.returncode == 0, (out + err)[-4000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's arrays, the port's arrays, rank 0's result)."""
    work = tmp_path_factory.mktemp("parallel")
    _side("ref", work)
    _side("ranks", work)
    return (dict(np.load(work / "ref.npz")), dict(np.load(work / "got.npz")),
            json.loads((work / "result.json").read_text()))


def _close(got, want, tol, what):
    top = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= tol * max(top, 1.0), f"{what}: max err {err:.3e} (max |want| {top:.3e})"


@pytest.mark.parametrize("case", list(EP_CASES))
def test_ep_matches_reference(case, runs):
    ref, got, _ = runs
    assert ref[f"{case}:gap"] > MIN_GAP, "a near-tie at a token's k-th choice"
    for name in ["out", "aux", "gx", "aux_gx", "aux_grouter"] + [f"g{k}" for k in EXPERT_KEYS]:
        key = f"{case}:{name}"
        assert (key in ref) == (key in got), key
        if key in ref:
            assert got[key].shape == ref[key].shape, key
            _close(got[key], ref[key], TOL, key)


@pytest.mark.parametrize("case", list(EP_CASES))
def test_ep_matches_dropping(case, runs):
    _, got, _ = runs
    np.testing.assert_allclose(got[f"{case}:out"], got[f"{case}:drop_out"],
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(float(got[f"{case}:aux"]), float(got[f"{case}:drop_aux"]),
                               rtol=1e-4)


def test_ep_padded_experts_on_the_last_rank_are_never_used(runs):
    """6 experts padded to 8 on (1, 4): rank 3 holds experts 6 and 7, which
    no token is routed to, so their weights get no grad."""
    _, got, _ = runs
    for route in ("ep_gather", "ep_shard_map"):
        case = f"granite6of8-{route}-1x4"
        for k in ("w1", "w2", "w3"):
            g = got[f"{case}:g{k}"]
            assert g.shape[0] == 8 and not g[6:].any() and g[:6].any(), (case, k)


def test_ep_gather_prefill_and_decode_bundles_match_reference(runs):
    ref, got, _ = runs
    for i in range(1 + STEPS):
        _close(got[f"logits{i}"], ref[f"want{i}"], TOL, f"logits {i}")


def test_ep_gather_train_step_matches_reference(runs):
    from test_torch_mesh_train import _close_state

    ref, got, result = runs
    (metrics,) = result["train"]
    for k in ("loss", "aux", "grad_norm", "lr"):
        want = float(ref[f"train:{k}"])
        assert abs(metrics[k] - want) <= TOL * max(abs(want), 1e-12), (k, metrics[k], want)
    keys = [k for k in ref if k.startswith("train:") and k[6:].startswith(("params", "mu", "nu"))]
    _close_state({k[6:]: got[k] for k in keys}, {k[6:]: ref[k] for k in keys})


@pytest.mark.parametrize("n_micro", N_MICRO)
def test_pipeline_matches_reference(n_micro, runs):
    ref, got, _ = runs
    for name in ("out", "gx", "gw"):
        key = f"pipe{n_micro}:{name}"
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-5, atol=1e-5, err_msg=key)
    want = ref["pipe:x"]
    for w in ref["pipe:ws"]:  # the sequential loop
        want = np.tanh(want @ w)
    np.testing.assert_allclose(got[f"pipe{n_micro}:out"], want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["mean", "tmean_a", "tmean_b"])
def test_compressed_mean_matches_reference(name, runs):
    ref, got, _ = runs
    mean = got[f"comp:{name}"]
    for i in range(1, 4):  # every rank holds the same mean
        np.testing.assert_array_equal(mean[i], mean[0])
    np.testing.assert_allclose(mean, ref[f"comp:{name}"], rtol=0, atol=1e-6)
    xs = ref["comp:y"] if name == "tmean_b" else ref["comp:x"]
    exact = xs.mean(0)
    amax = float(np.abs(xs).max()) + (0 if name == "tmean_b" else
                                      float(np.abs(ref["comp:err"]).max()))
    assert np.abs(mean[0] - exact).max() < 2 * amax / 127  # two quantization stages


@pytest.mark.parametrize("name", ["new_err", "tnew_a", "tnew_b"])
def test_compressed_mean_new_error_matches_reference(name, runs):
    ref, got, _ = runs
    np.testing.assert_allclose(got[f"comp:{name}"], ref[f"comp:{name}"], rtol=0, atol=1e-6)


def test_compressed_mean_keeps_the_wire_int8(runs):
    _, _, result = runs
    wire = result["wire"]
    assert {w[0] for w in wire} == {"all_to_all_single", "all_gather"}
    for fn, dtype, numel in wire:
        assert dtype == "torch.int8" or (fn == "all_gather" and dtype == "torch.float32"
                                         and numel == 1), (fn, dtype, numel)


# ---------------------------------------------------------------------------
# In this process
# ---------------------------------------------------------------------------


def _jax_quant():
    import jax.numpy as jnp

    from repro.optim import compression as JC
    return jnp, JC


@pytest.mark.parametrize("scale", [None, 0.25])
def test_quantize_int8_matches_jax_ties_included(scale):
    from repro_torch.optim import compression as C

    jnp, JC = _jax_quant()
    rng = np.random.default_rng(0)
    # 127 fixes the scale at 1.0 (0.25 given): the .5 multiples are exact ties
    x = np.concatenate([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 0.125, 0.375, -0.625],
                        rng.standard_normal(50) * 30]).astype(np.float32)
    jq, js = JC.quantize_int8(jnp.asarray(x), None if scale is None else jnp.float32(scale))
    q, s = C.quantize_int8(torch.from_numpy(x),
                           None if scale is None else torch.tensor(scale, dtype=torch.float32))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    np.testing.assert_array_equal(C.dequantize_int8(q, s).numpy(),
                                  np.asarray(JC.dequantize_int8(jq, js)))


def test_compress_with_feedback_matches_jax():
    from repro_torch.optim import compression as C

    jnp, JC = _jax_quant()
    rng = np.random.default_rng(1)
    g = rng.standard_normal((6, 7)).astype(np.float32)
    e = (rng.standard_normal((6, 7)) * 0.05).astype(np.float32)
    jq, js, je = JC.compress_with_feedback(jnp.asarray(g), jnp.asarray(e))
    q, s, new_e = C.compress_with_feedback(torch.from_numpy(g), torch.from_numpy(e))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    np.testing.assert_allclose(new_e.numpy(), np.asarray(je), rtol=0, atol=1e-7)
    tree = C.init_error_tree({"a": torch.zeros(2, 3, dtype=torch.bfloat16), "b": [torch.ones(4)]})
    assert tree["a"].dtype == tree["b"][0].dtype == torch.float32
    assert tree["a"].shape == (2, 3) and not tree["b"][0].any()


@pytest.mark.parametrize("route", ["ep_gather", "ep_shard_map"])
def test_ep_routes_raise_without_a_mesh(route):
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import moe as MOE
    from repro_torch.models.params import init_params
    from repro_torch.parallel.ep import ep_mesh

    cfg = _cfg(get_smoke_config, GRANITE, route, {})
    p = init_params(MOE.moe_defs(cfg), torch.Generator().manual_seed(0))
    want = {"ep_gather": "ep_gather requires ep_mesh\\(mesh\\)",
            "ep_shard_map": "ep_shard_map requires ep_mesh\\(mesh\\) with a 'model' axis"}[route]
    with pytest.raises(RuntimeError, match=want):
        MOE.apply_moe(p, torch.zeros(1, 4, cfg.d_model), cfg)
    with ep_mesh({"data": 4}), pytest.raises(RuntimeError, match=want):  # no "model" axis
        MOE.apply_moe(p, torch.zeros(1, 4, cfg.d_model), cfg)


@pytest.mark.parametrize("route", ["ep_gather", "ep_shard_map"])
def test_ep_routes_raise_when_model_does_not_divide_the_experts(route):
    """6 experts (unpadded) over a "model" of 4, on a fake group of 4."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs.base import get_smoke_config
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.models import moe as MOE
    from repro_torch.models.params import init_params
    from repro_torch.parallel.ep import ep_mesh

    cfg = _cfg(get_smoke_config, GRANITE, route, {"n_experts": 6})
    p = init_params(MOE.moe_defs(cfg), torch.Generator().manual_seed(0))
    with fake_world(4):
        mesh = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
        with ep_mesh(mesh), pytest.raises(ValueError, match="n_experts\\(_padded\\) 6"):
            MOE.apply_moe(p, torch.zeros(1, 4, cfg.d_model), cfg)


def test_stack_stage_params():
    from repro_torch.parallel.pipeline import stack_stage_params

    tree = {"w": torch.zeros(8, 3, 5), "b": [torch.zeros(8, 2)]}
    out = stack_stage_params(tree, 4)
    assert out["w"].shape == (4, 2, 3, 5) and out["b"][0].shape == (4, 2, 2)
    with pytest.raises(ValueError, match="layers 8 % stages 3"):
        stack_stage_params(tree, 3)


def test_pipeline_refuses_a_batch_n_micro_does_not_divide(tmp_path):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.parallel.pipeline import pipeline_apply

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv", rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("pod",))
        with pytest.raises(ValueError, match="batch 3 % n_micro 2"):
            pipeline_apply(lambda p, h: h, {}, torch.zeros(3, 4), mesh, n_micro=2)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _main(sys.argv[1], sys.argv[2])
