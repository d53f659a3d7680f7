"""The dry-run on a mesh (``launch/dryrun.py``, ``launch/analysis.py``):
the production mesh's shapes against the JAX package's, a fake rank's count
against a real rank's, the collective conventions against the reference's
``collective_stats``, the collectives against the specs' own counters, and
the records and CLI on 16 x 16 and 2 x 16 x 16.

A fake rank against a real one: the smoke configs of gemma-2b, hymba-1.5b
and granite-moe-3b-a800m, through prefill, decode and train (B = 4, S = 24),
on (2, 2) and (1, 4).  Each step is counted on ``meta`` as rank 0 of a
``"fake"`` group of 4 in this process (``count_cell``), and run for real on
4 gloo ranks on the CPU in a subprocess (this file is its ``__main__``; one
spawn a mesh runs every step) under ``StepCost(device="cpu")``, waiting for
each collective as it is issued (``_synchronous_cost``); rank 0's count must
equal the fake one exactly.  On the CPU a kernel call is
counted as the card counts it: the wrapper is charged on ``meta`` copies of
its arguments and its outputs are allocated in the count, while the plain
version that fills them runs outside it (``_as_on_the_card``).

The records: gemma-2b ``decode_32k`` and ``train_4k`` are the two
full-width cells (each counts in under 30 s on either mesh on one core:
2-4 s and 7-13 s), counted in a subprocess that starts with the module's
first test and runs beside the others, as the gloo runs do.
"""
import contextlib
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import _torch_threads  # noqa: F401  (one intra-op thread per test worker)

ROOT = Path(__file__).resolve().parents[1]
B, S = 4, 24
RUN_TIMEOUT = 300  # seconds for one 4-rank run of 9 steps, spawn to exit (~40-60 s alone)
ARCHS = ("gemma-2b", "hymba-1.5b", "granite-moe-3b-a800m")
KINDS = ("prefill", "decode", "train")
MESHES = ((2, 2), (1, 4))
CASES = [(a, k, m) for m in MESHES for a in ARCHS for k in KINDS]


def _shape(kind):
    from repro_torch.configs.base import ShapeConfig

    return ShapeConfig("x", S, B, kind)


def summary(cost):
    """What a count says of one device's step."""
    return {"flops": cost.flops, "bytes": cost.total_bytes, "input_bytes": cost.input_bytes,
            "peak": cost.peak, "kernel_calls": cost.kernel_calls,
            "collectives": cost.collectives()}


# ---------------------------------------------------------------------------
# The ranks (run as ``python tests/test_torch_mesh_dryrun.py <work dir>``)
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _as_on_the_card():
    """Each kernel wrapper, called on CPU tensors, counted as the card counts
    a launch: charged on ``meta`` copies of its arguments (no bytes, no
    storage on the CPU), its outputs allocated on the CPU in the count, and
    filled by the plain version outside the count."""
    from torch.utils._python_dispatch import _disable_current_modes

    from repro_torch.kernels import ops as kops

    def card_like(wrapper):
        def call(*args):
            metas = [torch.empty_strided(a.shape, a.stride(), dtype=a.dtype, device="meta")
                     for a in args]
            outs = wrapper(*metas)
            single = isinstance(outs, torch.Tensor)
            outs = [outs] if single else list(outs)
            res = [torch.empty(o.shape, dtype=o.dtype) for o in outs]
            with _disable_current_modes():
                got = wrapper(*args)
                for r, g in zip(res, [got] if single else got):
                    r.copy_(g)
            return res[0] if single else tuple(res)
        return call

    saved = {name: getattr(kops, name) for name in kops.KERNELS}
    try:
        for name, fn in saved.items():
            setattr(kops, name, card_like(fn))
        yield
    finally:
        for name, fn in saved.items():
            setattr(kops, name, fn)


def _synchronous_cost():
    """``StepCost`` waiting for each collective as it is issued: gloo's work
    holds its tensors until it completes on a thread of its own, so without
    the wait a storage's last reference could go at that thread's pace."""
    from repro_torch.launch.analysis import StepCost, collective_kind

    class Synchronous(StepCost):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if out is not NotImplemented and collective_kind(func):
                for t in ([out] if isinstance(out, torch.Tensor) else out):
                    torch.ops._c10d_functional.wait_tensor(t)
            return out
    return Synchronous


def _fill(tree, vocab: int, gen: torch.Generator):
    """Random values in the local shards of a tree of DTensors of zeros:
    floats ~ N(0, 0.02), tokens and targets in [0, vocab), the mask ones;
    other ints (positions, the step) stay 0."""
    def fill(key, t):
        local = t.to_local()
        if key == "mask":
            local.fill_(1)
        elif local.is_floating_point():
            local.normal_(0.0, 0.02, generator=gen)
        elif key in ("tokens", "targets"):
            local.random_(0, vocab, generator=gen)

    def walk(node, key=None):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, k)
        elif isinstance(node, list):
            for v in node:
                walk(v, key)
        else:
            fill(key, node)
    walk(tree)
    return tree


def _rank(rank: int, work: str) -> None:
    import torch.distributed as dist

    from repro_torch.configs.base import get_smoke_config
    from repro_torch.launch.dryrun import place_zeros
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.steps import make_step

    torch.set_num_threads(1)
    StepCost = _synchronous_cost()
    job = json.loads((Path(work) / "job.json").read_text())
    d, m = job["mesh"]
    dist.init_process_group("gloo", init_method=f"file://{work}/rdv", rank=rank,
                            world_size=d * m)
    try:
        mesh = make_local_mesh(d, m, device="cpu")
        out = {}
        for arch, kind in job["cases"]:
            cfg = get_smoke_config(arch)
            bundle = make_step(cfg, mesh, _shape(kind))
            specs = dict(zip(bundle.input_specs, bundle.in_shardings))
            gen = torch.Generator().manual_seed(rank)
            inputs = _fill(place_zeros(bundle.input_specs, mesh, specs, device="cpu"),
                           cfg.vocab, gen)
            with _as_on_the_card(), StepCost(inputs, device="cpu") as cost:
                res = bundle.fn(**inputs)
            del res
            out[f"{arch} {kind}"] = summary(cost)
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


def _start_ranks(work: Path) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, __file__, str(work)], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)


def _wait(proc: subprocess.Popen, timeout: float) -> str:
    """``proc``'s stdout once it exits 0; its process group is killed past
    ``timeout``, so a hung rank fails one test."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        pytest.fail(f"no result in {timeout}s:\n{err[-3000:]}")
    assert proc.returncode == 0, (out + err)[-4000:]
    return out


@pytest.fixture(scope="module", autouse=True)
def rank_runs(tmp_path_factory):
    """The gloo runs, one a mesh, started with the module's first test and
    running beside the others; ``real_counts`` waits for them."""
    runs = {}
    for mesh in MESHES:
        work = tmp_path_factory.mktemp(f"ranks{mesh[0]}x{mesh[1]}")
        cases = [[a, k] for a in ARCHS for k in KINDS]
        (work / "job.json").write_text(json.dumps({"mesh": list(mesh), "cases": cases}))
        runs[mesh] = (work, _start_ranks(work))
    yield runs
    for _, proc in runs.values():
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()


@pytest.fixture(scope="module")
def real_counts(rank_runs):
    """Rank 0's counts on 4 gloo ranks, by mesh, then "arch kind"."""
    out = {}
    for mesh, (work, proc) in rank_runs.items():
        _wait(proc, RUN_TIMEOUT)
        out[mesh] = json.loads((work / "result.json").read_text())
    return out


@pytest.fixture(scope="module")
def fake_counts():
    """The same steps counted on meta as rank 0 of a fake group of 4."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.launch import dryrun as DRY
    from repro_torch.launch.mesh import make_local_mesh

    out = {}
    with DRY.fake_world(4):
        for mesh in MESHES:
            dm = make_local_mesh(*mesh, device="cpu")
            out[mesh] = {f"{a} {k}": summary(DRY.count_cell(get_smoke_config(a), _shape(k), dm))
                         for a in ARCHS for k in KINDS}
    return out


@pytest.mark.parametrize("arch,kind,mesh", CASES)
def test_a_fake_rank_counts_what_a_real_rank_does(arch, kind, mesh, fake_counts, real_counts):
    fake = fake_counts[mesh][f"{arch} {kind}"]
    real = json.loads(json.dumps(real_counts[mesh][f"{arch} {kind}"]))
    fake = json.loads(json.dumps(fake))  # the same JSON round trip
    assert fake == real
    assert fake["peak"] > fake["input_bytes"] > 0 and fake["flops"] > 0
    if mesh[1] > 1:
        assert fake["collectives"]["total_operand"] > 0


# -- the production mesh ---------------------------------------------------------------------

JAX_MESH = r"""
import json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
from repro.launch.mesh import make_production_mesh
out = {}
for multi in (False, True):
    m = make_production_mesh(multi_pod=multi)
    out[str(multi)] = [list(m.devices.shape), list(m.axis_names)]
print("RESULT " + json.dumps(out))
"""


def test_production_mesh_is_the_references():
    import torch.distributed as dist

    from repro_torch.launch import dryrun as DRY
    from repro_torch.launch.mesh import make_production_mesh

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", JAX_MESH], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = json.loads([ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")][0][7:])
    with pytest.raises(RuntimeError, match="no process group"):
        make_production_mesh()
    with DRY.fake_world(4):
        with pytest.raises(RuntimeError, match="needs 256 ranks"):
            make_production_mesh(device="cpu")
        with pytest.raises(RuntimeError, match="needs 512 ranks"):
            make_production_mesh(multi_pod=True, device="cpu")
    for multi, n in ((False, 256), (True, 512)):
        with DRY.fake_world(n):
            with pytest.raises(RuntimeError, match="nccl"):
                make_production_mesh(multi_pod=multi)
            mesh = make_production_mesh(multi_pod=multi, device="cpu")
            assert [list(mesh.shape), list(mesh.mesh_dim_names)] == want[str(multi)]
        assert not dist.is_initialized()
    with DRY.fake_world(256):  # a fake group of another size, or another group, is refused
        with pytest.raises(RuntimeError, match="fake group of 512"):
            with DRY.fake_world(512):
                pass


# -- the conventions -------------------------------------------------------------------------

def _funcol_calls(g):
    """(HLO op, funcol call on a (64, 8) f32 meta tensor, its result shape)."""
    import torch.distributed._functional_collectives as fc
    import torch.distributed as dist

    group = dist.group.WORLD
    x = torch.empty(64, 8, device="meta")
    return [("all-reduce", lambda: fc.all_reduce(x, "sum", group), (64, 8)),
            ("all-gather", lambda: fc.all_gather_single(x, 0, group), (64 * g, 8)),
            ("reduce-scatter", lambda: fc.reduce_scatter_single(x, "sum", 0, group),
             (64 // g, 8)),
            ("all-to-all", lambda: fc.all_to_all_single(x, None, None, group), (64, 8))]


@pytest.mark.parametrize("g", [2, 4, 16])
def test_collective_conventions_are_the_references(g):
    from repro.launch import analysis as JAN
    from repro_torch.launch import dryrun as DRY
    from repro_torch.launch.analysis import StepCost

    with DRY.fake_world(g):
        for op, call, shape in _funcol_calls(g):
            with StepCost() as cost:
                out = call()
                if hasattr(out, "wait"):
                    out = out.wait()
            assert tuple(out.shape) == shape
            dims = ",".join(str(n) for n in shape)
            groups = "{{" + ",".join(str(i) for i in range(g)) + "}}"
            hlo = f"  %x.1 = f32[{dims}]{{1,0}} {op}(f32[64,8]{{1,0}} %p), replica_groups={groups}"
            want = JAN.collective_stats(hlo)
            got = cost.collectives()
            assert got["counts"] == want.counts == {op: 1}
            assert got["operand_bytes"] == want.operand_bytes
            assert got["wire_bytes"] == want.wire_bytes
            assert cost.total_bytes == 0  # collective bytes are not the op bytes


# -- the specs' own counters -----------------------------------------------------------------


def _where(kind: str) -> str:
    """Who issued a collective: "relayout" when a ``sharding.relayout`` call
    is on the stack, else the innermost function of the port's code."""
    import traceback

    frames = [f for f in traceback.extract_stack()
              if "repro_torch" in f.filename and not f.filename.endswith("analysis.py")]
    return "relayout" if any(f.name == "relayout" for f in frames) else frames[-1].name


def test_train_collectives_match_the_relayout_counters(monkeypatch):
    """gemma-smoke's train step (B = 8) as rank 0 of a fake (8, 1) mesh:
    the bytes ``relayout`` counts as reduced (what a rank sends into an
    all-reduce or a reduce-scatter) and gathered (what an all-gather grows a
    rank's shard by) are those of the collectives its calls issue; the
    collectives the counter sees beyond those are named in ``UNSEEN``."""
    from repro_torch import sharding as SH
    from repro_torch.configs.base import ShapeConfig, get_smoke_config
    from repro_torch.launch import analysis as AN
    from repro_torch.launch import dryrun as DRY
    from repro_torch.launch.mesh import make_local_mesh

    seen = {}
    record = AN.StepCost._collective

    def spy(self, kind, nbytes, group_size):
        operand, wire = AN.collective_bytes(kind, nbytes, group_size)
        key = (kind, _where(kind))
        got = seen.setdefault(key, [0, 0])
        got[0] += operand
        got[1] += wire
        record(self, kind, nbytes, group_size)

    monkeypatch.setattr(AN.StepCost, "_collective", spy)
    with DRY.fake_world(8):
        mesh = make_local_mesh(8, 1, device="cpu")
        SH.relayout.reduced_bytes = SH.relayout.gathered_bytes = 0
        cost = DRY.count_cell(get_smoke_config("gemma-2b"), ShapeConfig("x", S, 8, "train"),
                              mesh)
        reduced, gathered = SH.relayout.reduced_bytes, SH.relayout.gathered_bytes
    coll = cost.collectives()
    assert sum(v[0] for v in seen.values()) == coll["total_operand"]
    assert reduced == sum(seen.get((k, "relayout"), [0])[0]
                          for k in ("all-reduce", "reduce-scatter")) > 0
    assert gathered == seen[("all-gather", "relayout")][1] > 0
    unseen = {key: v[0] for key, v in seen.items() if key[1] != "relayout"}
    assert unseen == UNSEEN


# the collectives of that step that ``relayout``'s counters do not see, by
# (kind, issuing function): operand bytes.  DTensor's own reductions of the
# loss's f32 denominator sum(mask) and of the loss as a full tensor, 4 bytes
# each; and autograd's reverse of the forward's re-placements in the
# backward (``train_step``'s ``total.backward()``): a gather's grad is
# reduce-scattered (the (256, 64) f32 embedding's), a reduction's grad
# gathered.
UNSEEN = {("all-reduce", "cross_entropy"): 4, ("all-reduce", "_full"): 4,
          ("reduce-scatter", "train_step"): 256 * 64 * 4, ("all-gather", "train_step"): 6240}


# -- the records and the CLI -----------------------------------------------------------------

RECORDS = r"""
import json, resource
import torch
from repro_torch.launch.dryrun import run_cell
out = {}
for arch, shape in [("gemma-2b", "decode_32k"), ("gemma-2b", "train_4k")]:
    for multi in (False, True):
        out[f"{arch} {shape} {multi}"] = run_cell(arch, shape, multi_pod=multi, verbose=False)
out["maxrss_kib"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
out["cuda_initialized"] = torch.cuda.is_initialized()
print("RESULT " + json.dumps(out))
"""
CELLS = [("gemma-2b", "decode_32k"), ("gemma-2b", "train_4k")]


@pytest.fixture(scope="module", autouse=True)
def records_process():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.Popen([sys.executable, "-c", RECORDS], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            start_new_session=True)
    yield proc
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
    proc.communicate()


@pytest.fixture(scope="module")
def records(records_process):
    out = _wait(records_process, 300)
    return json.loads([ln for ln in out.splitlines() if ln.startswith("RESULT ")][0][7:])


@pytest.fixture(scope="module")
def one_device():
    from repro_torch.configs.base import SHAPES, get_config
    from repro_torch.launch import dryrun as DRY

    return {cell: DRY.account(cell[0], get_config(cell[0]), SHAPES[cell[1]],
                              DRY.default_strategy(*cell), verbose=False)
            for cell in CELLS}


# the reference's record keys and the port's names for those that named XLA
REF_KEYS = {"arch", "shape", "mesh", "strategy", "kind", "n_chips", "compile_s", "accounting",
            "hlo_flops_per_dev", "hlo_bytes_per_dev", "scanned_flops_per_dev", "collectives",
            "collectives_scanned", "memory", "roofline", "model_flops_global",
            "model_flops_per_dev", "useful_flops_ratio", "hbm_fit", "n_params",
            "n_active_params"}
RENAMED = {"compile_s": "count_s", "hlo_flops_per_dev": "flops_per_dev",
           "hlo_bytes_per_dev": "bytes_per_dev"}


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_mesh_record(records, one_device, cell, multi):
    rec = records[f"{cell[0]} {cell[1]} {multi}"]
    assert {RENAMED.get(k, k) for k in REF_KEYS} <= set(rec)
    n = 512 if multi else 256
    assert (rec["mesh"], rec["n_chips"]) == (("2x16x16", 512) if multi else ("16x16", 256))
    assert rec["collectives_scanned"] == rec["collectives"]
    assert rec["model_flops_per_dev"] == rec["model_flops_global"] / n
    assert rec["useful_flops_ratio"] == rec["model_flops_per_dev"] / rec["flops_per_dev"]
    assert rec["hbm_fit"] == (rec["memory"]["peak_bytes_per_device"] <= 80 * 2**30)
    assert rec["roofline"]["collective_s"] > 0
    assert rec["accounting"]["counted_on"] == ("32x16" if multi else "16x16")
    one = one_device[cell]
    assert rec["flops_per_dev"] * n >= one["flops_per_dev"] * (1 - 1e-3)
    assert rec["memory"]["peak_bytes_per_device"] < one["memory"]["peak_bytes_per_device"]
    if rec["kind"] == "train":
        assert rec["collectives"]["total_operand"] > 0
        assert rec["collectives"]["counts"].get("reduce-scatter", 0) + \
            rec["collectives"]["counts"].get("all-reduce", 0) > 0


def test_mesh_records_allocate_nothing(records):
    assert records["maxrss_kib"] < 3 * 2**20
    assert records["cuda_initialized"] is False


def test_cli_both_meshes_and_strategy(tmp_path):
    """``--both-meshes`` writes single/ and multi/ records; ``--strategy
    fsdp_tp`` is recorded and shards the params over "data" too."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    base = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "gemma-2b",
            "--shape", "decode_32k"]
    for extra, out in ((["--both-meshes"], "tp"), (["--strategy", "fsdp_tp"], "fsdp")):
        proc = subprocess.run(base + ["--out", str(tmp_path / out)] + extra, env=env,
                              capture_output=True, text=True, timeout=240)
        assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
        assert "ALL DRY-RUN CELLS OK" in proc.stdout
    recs = {(out, tag): json.loads((tmp_path / out / tag / "gemma-2b__decode_32k.json")
                                   .read_text())
            for out, tag in (("tp", "single"), ("tp", "multi"), ("fsdp", "single"))}
    assert not (tmp_path / "fsdp" / "multi").exists()
    for (out, tag), rec in recs.items():
        assert rec["mesh"] == {"single": "16x16", "multi": "2x16x16"}[tag]
        assert rec["strategy"] == {"tp": "tp", "fsdp": "fsdp_tp"}[out]
    tp, fsdp = recs[("tp", "single")]["memory"], recs[("fsdp", "single")]["memory"]
    assert fsdp["argument_size_in_bytes"] < tp["argument_size_in_bytes"]


# The smallest train counts on 2 x 16 x 16's (32, 16) ``tp`` view (the archs'
# own head counts, depth and sequence cut, B = 256 as in train_4k) that raised
# in DTensor's backward before the repair: (arch, layers, seq) and what raised.
# The (batch, heads) dim of an einsum's batched product was sharded over all
# 512 ranks, 256 rows over 512, and could not be split back (hymba, xlstm at
# 256 tokens; ``sharding.batch_einsum``); a grad sharded over more ranks than
# the heads it splits into (granite-3-8b's 8 kv heads, xlstm's 4; whisper's 20
# heads; ``sharding.pin_grad`` and ``xlstm._split_heads``; xlstm's sLSTM merge
# raised only once its gate's split was mended).
POD_FAULTS = {
    "hymba-1.5b": (2, 512),  # shape '[1, 5, 512, 5, 512, 1]' is invalid
    "xlstm-125m-einsum": (1, 256),  # shape '[1, 4, 256, 256, 1]' is invalid
    "xlstm-125m-gate": (1, 16),  # Cannot unflatten: output dimension 0 (size 4)
    "xlstm-125m-slstm": (4, 64),  # the same, at the sLSTM's (H, dh) merge (layer 4)
    "granite-3-8b": (2, 64),  # Cannot unflatten: output dimension 0 (size 8)
    "whisper-large-v3": (2, 16),  # Cannot flatten: dimension 3 (size 20)
}


def _cut_cell(arch: str, layers: int, seq: int, mesh):
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.launch.dryrun import count_cell

    cfg = get_config(arch, n_layers=layers, **({"n_enc_layers": layers}
                                                if arch == "whisper-large-v3" else {}))
    return count_cell(cfg, ShapeConfig("train_4k", seq, 256, "train"), mesh)


@pytest.mark.parametrize("case", list(POD_FAULTS))
def test_train_counts_on_the_pod_mesh_where_dtensor_raised(case):
    from repro_torch.launch.dryrun import fake_world, tp_view
    from repro_torch.launch.mesh import make_production_mesh

    arch = "xlstm-125m" if case.startswith("xlstm") else case
    with fake_world(512):
        mesh = tp_view(make_production_mesh(multi_pod=True, device="cpu"))
        cost = _cut_cell(arch, *POD_FAULTS[case], mesh)
    coll = cost.collectives()
    assert cost.flops > 0 and coll["total_operand"] > 0
    assert coll["counts"].get("all-reduce", 0) + coll["counts"].get("reduce-scatter", 0) > 0


@pytest.mark.parametrize("arch,layers,seq", [("granite-3-8b", 2, 64), ("whisper-large-v3", 2, 16),
                                            ("hymba-1.5b", 2, 64)])
def test_the_pod_mesh_repair_leaves_16x16_counts_as_they_were(arch, layers, seq, monkeypatch):
    """On 16 x 16 the repair's grad pins and batch islands change nothing:
    the count with them equals the count with both replaced by the plain
    ops they wrap."""
    from repro_torch import sharding as SH
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_production_mesh

    with fake_world(256):
        mesh = make_production_mesh(device="cpu")
        with_repair = summary(_cut_cell(arch, layers, seq, mesh))
        monkeypatch.setattr(SH, "pin_grad", lambda t, dim, heads: t)
        monkeypatch.setattr(SH, "batch_einsum", lambda eq, *ops: torch.einsum(eq, *ops))
        without = summary(_cut_cell(arch, layers, seq, mesh))
    assert with_repair == without

if __name__ == "__main__":
    _main(sys.argv[1])
