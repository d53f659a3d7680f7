"""The sharded prefill and decode bundles on a mesh of 4 gloo ranks on the
CPU, against the JAX package's unsharded prefill and decode.

Sharding does not change JAX's result, so the JAX side runs unsharded in
the test process: ``prefill`` over a 16-token prompt (B = 4, cache of 24)
and 4 ``decode_step``s, on params it makes.  The port's side runs in a
subprocess that spawns 4 ranks (this file is its ``__main__``) over a
``file://`` rendezvous under the test's ``tmp_path``, each with one
intra-op thread; the whole run has its own timeout (``RUN_TIMEOUT``), after
which its process group is killed, so a hung rank fails one test.  Each
rank places the carried params by the bundle's ``in_shardings``
(``params_from_numpy(..., mesh, specs)``), runs the bundles with
``attention_impl="pallas"`` (K1, K2 and K4 in their ``local_map`` islands;
the plain versions on the CPU), and rank 0 reports: the logits' and the
full cache's largest differences from JAX's (tolerance 2e-4, f32), and
whether each cache leaf's placements equal those converted from JAX's
``cache_pspecs`` on an abstract mesh of the same shape.

The cases: gemma-smoke (MQA: its cache is sharded on head_dim) and
hymba-smoke (2 kv heads, sharded over "model" on (2, 2); on (1, 4) its
cache falls back to head_dim and no head split is exact for the kernels)
under ``tp`` and ``fsdp_tp`` on (2, 2) and ``tp`` on (1, 4); hymba with
``attention_impl="blockwise"`` and ``attention_partitioning="seq"``; gemma
with ``decode_seq_shard=True`` (its cache sharded on M).

In this process: the families that do not run on a mesh raise, a DTensor
given to a kernel wrapper raises ``TypeError``, ``make_local_mesh``
without a group of the right size raises, a bundle refuses inputs placed
otherwise, and on a (1, 1) mesh the bundles give the unsharded bundles'
numbers.
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
B, PROMPT, MAX_LEN, STEPS = 4, 16, 24, 4
RUN_TIMEOUT = 150  # seconds for one 4-rank run, spawn to exit (13-24 s on 8 CPU cores)

CASES = {
    "gemma-tp-2x2": ("gemma-2b", "tp", (2, 2), {}),
    "gemma-fsdp_tp-2x2": ("gemma-2b", "fsdp_tp", (2, 2), {}),
    "gemma-tp-1x4": ("gemma-2b", "tp", (1, 4), {}),
    "gemma-seqcache-2x2": ("gemma-2b", "tp", (2, 2), {"decode_seq_shard": True}),
    "hymba-tp-2x2": ("hymba-1.5b", "tp", (2, 2), {}),
    "hymba-fsdp_tp-2x2": ("hymba-1.5b", "fsdp_tp", (2, 2), {}),
    "hymba-tp-1x4": ("hymba-1.5b", "tp", (1, 4), {}),
    "hymba-blockwise-seq-2x2": ("hymba-1.5b", "tp", (2, 2),
                                {"attention_impl": "blockwise",
                                 "attention_partitioning": "seq", "attention_block_q": 8}),
}


# ---------------------------------------------------------------------------
# The ranks (run as ``python tests/test_torch_mesh_steps.py <work dir>``)
# ---------------------------------------------------------------------------


def _rank(rank: int, work: str) -> None:
    import torch.distributed as dist

    from repro_torch import sharding as SH
    from repro_torch.configs.base import ShapeConfig, get_smoke_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import transformer as TF
    from repro_torch.models.params import params_from_numpy, tree_paths, tree_unflatten
    from repro_torch.steps import make_decode_step, make_prefill_step

    torch.set_num_threads(1)
    job = json.loads((Path(work) / "job.json").read_text())
    data = np.load(Path(work) / "data.npz")
    (d, m), n = job["mesh"], job["mesh"][0] * job["mesh"][1]
    dist.init_process_group("gloo", init_method=f"file://{work}/rdv", rank=rank, world_size=n)
    try:
        mesh = make_local_mesh(d, m, device="cpu")
        cfg = get_smoke_config(job["arch"], **{"attention_impl": "pallas", **job["over"]})
        pre = make_prefill_step(cfg, mesh, ShapeConfig("p", MAX_LEN, B, "prefill"),
                                job["strategy"])
        dec = make_decode_step(cfg, mesh, ShapeConfig("d", MAX_LEN, B, "decode"),
                               job["strategy"])
        leaves = [data[f"param{i}"] for i in range(job["n_params"])]
        params = params_from_numpy(tree_unflatten(TF.model_defs(cfg), leaves), "cpu", mesh,
                                   pre.in_shardings[0])
        out = {"logits": [], "placements": {}}

        def place(tokens, specs):
            return SH.distribute({"tokens": torch.from_numpy(tokens)}, mesh, specs)

        try:  # a batch placed otherwise is refused
            pre.fn(params, {"tokens": torch.from_numpy(data["prompt"])})
            out["refused"] = False
        except ValueError:
            out["refused"] = True
        logits, cache = pre.fn(params, place(data["prompt"], pre.in_shardings[1]))
        out["logits"].append(float(np.abs(logits.numpy() - data["want0"]).max()))
        for path, t in tree_paths(cache):
            out["placements"][path] = [str(p) for p in t.placements]
        SH.relayout.gathered_bytes = 0
        for i in range(STEPS):
            logits, cache = dec.fn(params, cache, place(data[f"step{i}"], dec.in_shardings[2]))
            out["logits"].append(float(np.abs(logits.numpy() - data[f"want{i + 1}"]).max()))
        out["gathered_bytes_per_step"] = SH.relayout.gathered_bytes / STEPS
        out["cache"] = {path: float(np.abs(t.full_tensor().numpy() - data[f"cache:{path}"]).max())
                        for path, t in tree_paths(cache)}
        if rank == 0:
            (Path(work) / "result.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def _main(work: str) -> None:
    import torch.multiprocessing as mp

    job = json.loads((Path(work) / "job.json").read_text())
    mp.spawn(_rank, args=(work,), nprocs=job["mesh"][0] * job["mesh"][1])


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------


def _jax_side(arch, over, mesh_shape, work: Path):
    """JAX's numbers on the case's inputs, written for the ranks; returns
    (the job, JAX's cache placements on the mesh as strings)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AbstractMesh

    from repro import sharding as JSH
    from repro.configs.base import get_smoke_config
    from repro.models import decoding as JDEC
    from repro.models import params as JP
    from repro.models import transformer as JTF
    from repro_torch import sharding as TSH

    jcfg = get_smoke_config(arch, **over)
    jp = JP.init_params(jax.random.PRNGKey(3), JTF.model_defs(jcfg))
    rng = np.random.default_rng(7)
    arrays = {"prompt": rng.integers(0, jcfg.vocab, (B, PROMPT)).astype(np.int32)}
    logits, cache = JDEC.prefill(jp, jcfg, {"tokens": jnp.asarray(arrays["prompt"])}, MAX_LEN)
    arrays["want0"] = np.asarray(logits)
    for i in range(STEPS):
        arrays[f"step{i}"] = rng.integers(0, jcfg.vocab, (B, 1)).astype(np.int32)
        logits, cache = JDEC.decode_step(jp, jcfg, cache, jnp.asarray(arrays[f"step{i}"]))
        arrays[f"want{i + 1}"] = np.asarray(logits)
    for path, leaf in jax.tree_util.tree_leaves_with_path(cache):
        arrays[f"cache:{jax.tree_util.keystr(path)}"] = np.asarray(leaf)
    leaves = jax.tree_util.tree_leaves(jp)
    for i, leaf in enumerate(leaves):
        arrays[f"param{i}"] = np.asarray(leaf)
    np.savez(work / "data.npz", **arrays)
    amesh = AbstractMesh(mesh_shape, ("data", "model"))
    jspecs = JSH.cache_pspecs(jcfg, JDEC.cache_specs(jcfg, B, MAX_LEN), amesh)
    layout = dict(zip(("data", "model"), mesh_shape))
    want = {jax.tree_util.keystr(path): [str(p) for p in TSH.placements(TSH.P(*spec), layout)]
            for path, spec in jax.tree_util.tree_leaves_with_path(
                jspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))}
    return {"n_params": len(leaves)}, want


def _run_ranks(work: Path, script: str = __file__) -> None:
    """Run ``script``'s ranks on ``work`` in a process group of their own,
    killed past ``RUN_TIMEOUT``."""
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


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_prefill_and_decode_match_jax(case, tmp_path):
    arch, strategy, mesh_shape, over = CASES[case]
    job, want_placements = _jax_side(arch, over, mesh_shape, tmp_path)
    job.update(arch=arch, strategy=strategy, mesh=list(mesh_shape), over=over)
    (tmp_path / "job.json").write_text(json.dumps(job))
    _run_ranks(tmp_path)
    got = json.loads((tmp_path / "result.json").read_text())
    assert got["refused"], "a batch of plain tensors was not refused"
    assert max(got["logits"]) <= TOL, got["logits"]
    assert len(got["logits"]) == 1 + STEPS
    assert sorted(got["cache"]) == sorted(want_placements)
    assert max(got["cache"].values()) <= TOL, got["cache"]
    assert got["placements"] == want_placements


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "phi-3-vision-4.2b",
                                  "whisper-large-v3", "xlstm-125m"])
def test_families_not_on_a_mesh_raise(arch, one_rank):
    """No family is left off a mesh: the prefill, decode and train bundles
    of the moe, vlm, encdec and ssm families build on the (2, 2) layout, and
    on a one-rank gloo mesh ``init_cache`` gives every leaf its
    ``cache_pspecs`` placements and the values of the plain cache (the
    xlstm states their -1e30 stabilisers too)."""
    from torch.distributed.tensor import DTensor

    from repro_torch import sharding as SH
    from repro_torch.configs.base import ShapeConfig, get_smoke_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import decoding as DEC
    from repro_torch.models.params import tree_paths
    from repro_torch.steps import make_step

    cfg = get_smoke_config(arch)
    for kind in ("prefill", "decode", "train"):
        bundle = make_step(cfg, {"data": 2, "model": 2}, ShapeConfig(kind, 32, 4, kind))
        assert bundle.in_shardings is not None and bundle.out_shardings is not None
    mesh = make_local_mesh(1, 1, device="cpu")
    cache = DEC.init_cache(cfg, 4, 32, device="cpu", mesh=mesh)
    plain = DEC.init_cache(cfg, 4, 32, device="cpu")
    specs = dict(tree_paths(SH.cache_pspecs(cfg, plain, mesh)))
    for (path, t), (wpath, w) in zip(tree_paths(cache), tree_paths(plain)):
        assert path == wpath and isinstance(t, DTensor), path
        assert t.placements == SH.placements(specs[path], mesh), path
        assert t.dtype == w.dtype and torch.equal(t.full_tensor(), w), path


@pytest.fixture
def one_rank(tmp_path):
    """A gloo process group of one rank in this process, torn down after."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv", rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _wrapper_args(name):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 4, 2, 16, generator=g)
    if name == "flash_attention":
        return q, q.clone(), q.clone()
    if name == "decode_attention":
        return q[:, :1], q.clone(), q.clone(), torch.full((1,), 4, dtype=torch.int32)
    if name == "ssm_scan":
        return torch.rand(1, 4, 2, 4, generator=g), torch.rand(1, 4, 2, 4), torch.rand(1, 4, 4)
    return (torch.rand(1, 4, 2), torch.rand(1, 4, 4), torch.rand(1, 4, 4), torch.rand(1, 4, 2),
            -torch.rand(2, 4))


@pytest.mark.parametrize("name", ["flash_attention", "decode_attention", "ssm_scan",
                                  "ssm_scan_fused"])
def test_kernel_wrappers_refuse_a_dtensor(name, one_rank):
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.kernels import ops as kops
    from repro_torch.launch.mesh import make_local_mesh

    mesh = make_local_mesh(1, 1, device="cpu")
    args = _wrapper_args(name)
    kops.KERNELS[name](*args)  # plain tensors: the plain version
    placed = [distribute_tensor(a, mesh, [Replicate(), Replicate()]) for a in args]
    for i in range(len(args)):
        mixed = list(args)
        mixed[i] = placed[i]
        with pytest.raises(TypeError, match="DTensor"):
            kops.KERNELS[name](*mixed)


def test_make_local_mesh_needs_a_group_of_its_size(tmp_path):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh

    with pytest.raises(RuntimeError, match="no process group"):
        make_local_mesh(1, 1, device="cpu")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv", rank=0,
                            world_size=1)
    try:
        with pytest.raises(RuntimeError, match="needs 4 ranks"):
            make_local_mesh(2, 2, device="cpu")
        with pytest.raises(RuntimeError, match="nccl"):
            make_local_mesh(1, 1)
        assert make_local_mesh(1, 1, device="cpu").mesh_dim_names == ("data", "model")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["gemma-2b", "hymba-1.5b", "granite-moe-3b-a800m",
                                  "phi-3-vision-4.2b", "whisper-large-v3", "xlstm-125m"])
def test_one_by_one_mesh_matches_no_mesh(arch, one_rank):
    """On a (1, 1) mesh every placement is a Shard or a Replicate over one
    rank: the bundles give the unsharded bundles' numbers and refuse plain
    inputs, the train bundle's step too (for the moe family: the dispatch
    island's arithmetic is ``mesh=None``'s)."""
    from repro_torch import sharding as SH
    from repro_torch.configs.base import ShapeConfig, get_smoke_config
    from repro_torch.data.pipeline import with_frontend_stubs
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.params import tree_map, tree_paths
    from repro_torch.optim import adamw_init
    from repro_torch.steps import init_model, make_decode_step, make_prefill_step, make_step

    mesh = make_local_mesh(1, 1, device="cpu")
    cfg = get_smoke_config(arch, attention_impl="pallas")
    pre_shape, dec_shape = ShapeConfig("p", 24, 2, "prefill"), ShapeConfig("d", 24, 2, "decode")
    _, params = init_model(cfg, seed=1, max_seq=24, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 8), generator=torch.Generator().manual_seed(2))
    step = torch.randint(0, cfg.vocab, (2, 1), generator=torch.Generator().manual_seed(3))
    stubs = {k: torch.from_numpy(v) for k, v in with_frontend_stubs(
        {"tokens": tokens.numpy()}, cfg).items() if k != "tokens"}
    prompt = {"tokens": tokens, **stubs}
    want, wcache = make_prefill_step(cfg, None, pre_shape).fn(params, prompt)
    want_step, wcache = make_decode_step(cfg, None, dec_shape).fn(params, wcache,
                                                                  {"tokens": step})
    pre = make_prefill_step(cfg, mesh, pre_shape)
    dec = make_decode_step(cfg, mesh, dec_shape)
    with pytest.raises(ValueError, match="placed"):
        pre.fn(params, prompt)
    sparams = SH.distribute(params, mesh, pre.in_shardings[0])
    got, cache = pre.fn(sparams, SH.distribute(prompt, mesh, pre.in_shardings[1]))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="placed"):
        dec.fn(sparams, cache, {"tokens": step})
    got_step, cache = dec.fn(sparams, cache,
                             SH.distribute({"tokens": step}, mesh, dec.in_shardings[2]))
    torch.testing.assert_close(got_step, want_step, rtol=0, atol=1e-6)
    for (path, t), (_, w) in zip(tree_paths(cache), tree_paths(wcache)):
        torch.testing.assert_close(t.full_tensor(), w, rtol=0, atol=1e-6, msg=path)
    train_shape = ShapeConfig("t", 24, 2, "train")
    train_cfg = dataclasses.replace(cfg, attention_impl="xla")  # K1 has no backward
    batch = {"tokens": tokens, "targets": torch.roll(tokens, -1, 1),
             "mask": torch.ones(2, 8), **stubs}
    want_p, _, want_m = make_step(train_cfg, None, train_shape).fn(
        tree_map(torch.clone, params), adamw_init(params), batch)
    train = make_step(train_cfg, mesh, train_shape)
    with pytest.raises(ValueError, match="placed"):
        train.fn(sparams, adamw_init(sparams, train.in_shardings[1]), batch)
    got_p, _, got_m = train.fn(sparams, adamw_init(sparams, train.in_shardings[1]),
                               SH.distribute(batch, mesh, train.in_shardings[2]))
    for k in ("loss", "grad_norm"):
        torch.testing.assert_close(got_m[k], want_m[k], rtol=1e-6, atol=0, msg=k)
    for (path, t), (_, w) in zip(tree_paths(got_p), tree_paths(want_p)):
        torch.testing.assert_close(t.detach().full_tensor(), w.detach(), rtol=0, atol=1e-6,
                                   msg=path)


if __name__ == "__main__":
    _main(sys.argv[1])
