"""The port's step bundles and dry-run against the JAX package's, on the CPU:
for every cell of the (arch x shape) matrix, ``batch_specs``, ``cache_specs``
(with the window rule of ``make_decode_step``) and ``model_flops``; for
every arch, ``abstract_params``; the bundles' steps at smoke size against
the reference bundles' ``fn`` (called without ``jit`` on a 1 x 1 mesh);
the one-device record (``account(..., mesh=None)``) of the cells of
``tests/test_dryrun_smoke.py`` and of nemotron-4-340b ``train_4k``, in a
subprocess; the step counter's FLOPs
against counts of the matmuls written here, its peak on ``meta`` against a
real CPU run, and the kernel wrappers on ``meta``.

Params are made by the JAX package and carried over with
``params_from_numpy``; other inputs come from ``make_synthetic_batch`` and
are carried the other way.  Tolerance: 2e-4 (in-model parity).
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import steps as JS
from repro.configs import base as JC
from repro.launch import analysis as JAN
from repro.launch.mesh import make_local_mesh
from repro.models import decoding as JDEC
from repro.models import params as JP
from repro.models import transformer as JTF
from repro_torch import steps as TS
from repro_torch.configs import base as TC
from repro_torch.kernels import ops as kops
from repro_torch.launch import analysis as TAN
from repro_torch.launch import dryrun as TDRY
from repro_torch.models import decoding as TDEC
from repro_torch.models import transformer as TTF
from repro_torch.models.params import (abstract_params, params_from_numpy, tree_leaves,
                                       tree_paths)
from repro_torch.optim import adamw as TA

import _torch_threads  # noqa: F401  (one intra-op thread per test worker)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=2e-4, atol=2e-4)
CELLS = JC.cells(include_skipped=True)


def _shape_dtype(t):
    """(shape, dtype name) of a torch or JAX array / ShapeDtypeStruct."""
    name = str(t.dtype).replace("torch.", "")
    return tuple(t.shape), name


def _jax_paths(tree):
    return [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _same_specs(got, want):
    """The same paths (sorted keys), shapes and dtypes."""
    assert [p for p, _ in tree_paths(got)] == _jax_paths(want)
    assert [_shape_dtype(t) for t in tree_leaves(got)] == \
        [_shape_dtype(t) for t in jax.tree_util.tree_leaves(want)]
    assert all(t.device.type == "meta" for t in tree_leaves(got))


def _cell_cfgs(arch, shape_name):
    return JC.get_config(arch), TC.get_config(arch), JC.SHAPES[shape_name], TC.SHAPES[shape_name]


# -- every cell ---------------------------------------------------------------------------


def test_the_cells_are_the_references():
    assert TC.cells(include_skipped=True) == CELLS and len(CELLS) == 40
    assert TC.cells() == JC.cells()


@pytest.mark.parametrize("arch,shape_name,status", CELLS)
def test_batch_specs_match_jax(arch, shape_name, status):
    jcfg, tcfg, jshape, tshape = _cell_cfgs(arch, shape_name)
    _same_specs(TS.batch_specs(tcfg, tshape), JS.batch_specs(jcfg, jshape))


@pytest.mark.parametrize("arch,shape_name,status", CELLS)
def test_cache_specs_match_jax(arch, shape_name, status):
    """At the cell's batch and length, with ``make_decode_step``'s window
    (``long_window`` on long_500k, reference steps.py:155)."""
    jcfg, tcfg, jshape, tshape = _cell_cfgs(arch, shape_name)
    window = TS.decode_window(tcfg, tshape)
    assert window == (jcfg.long_window if shape_name == "long_500k" else 0)
    want = JDEC.cache_specs(jcfg, jshape.global_batch, jshape.seq_len, window)
    _same_specs(TDEC.cache_specs(tcfg, tshape.global_batch, tshape.seq_len, window), want)


@pytest.mark.parametrize("arch,shape_name,status", CELLS)
def test_model_flops_match_jax(arch, shape_name, status):
    jcfg, tcfg, jshape, tshape = _cell_cfgs(arch, shape_name)
    assert TAN.model_flops(tcfg, tshape) == JAN.model_flops(jcfg, jshape)


@pytest.mark.parametrize("arch", JC.ARCH_IDS)
def test_abstract_params_match_jax(arch):
    jcfg, tcfg = JC.get_config(arch), TC.get_config(arch)
    _same_specs(abstract_params(TTF.model_defs(tcfg, max_seq=4096)),
                JP.abstract_params(JTF.model_defs(jcfg, max_seq=4096)))


def test_bundle_input_specs():
    """Every bundle's inputs are meta tensors; train holds the params, their
    AdamW state and the batch, and donates the first two; decode donates
    its cache."""
    cfg = TC.get_smoke_config("gemma-2b")
    train = TS.make_step(cfg, None, TC.ShapeConfig("t", 16, 2, "train"))
    assert list(train.input_specs) == ["params", "opt_state", "batch"]
    assert train.donate_argnames == ("params", "opt_state")
    assert [_shape_dtype(t) for t in tree_leaves(train.input_specs["opt_state"]["mu"])] == \
        [(tuple(t.shape), "float32") for t in tree_leaves(train.input_specs["params"])]
    decode = TS.make_step(cfg, None, TC.ShapeConfig("d", 16, 2, "decode"))
    assert list(decode.input_specs) == ["params", "cache", "batch"]
    assert decode.donate_argnames == ("cache",)
    for bundle in (train, decode):
        assert all(t.device.type == "meta" for t in tree_leaves(bundle.input_specs))


# -- the bundles' steps at smoke size against the reference's ------------------------------


def _carry(jtree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jtree), "cpu")


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _smoke(arch, **kw):
    return JC.get_smoke_config(arch, **kw), TC.get_smoke_config(arch, **kw)


def _batch(tcfg, shape, seed):
    tb = TS.make_synthetic_batch(tcfg, shape, seed=seed, device="cpu")
    return tb, {k: jnp.asarray(v.numpy()) for k, v in tb.items()}


@pytest.mark.parametrize("arch,shape_name", [
    ("gemma-2b", "decode_32k"), ("granite-moe-3b-a800m", "decode_32k"),
    ("hymba-1.5b", "decode_32k"), ("hymba-1.5b", "long_500k"), ("xlstm-125m", "long_500k")])
def test_prefill_and_decode_bundles_match_jax(arch, shape_name):
    """The prefill bundle over a 20-token prompt (B = 2, cache of 40), then
    the decode bundle of the cell's name at that length, three steps from the
    prefill's cache: on long_500k hymba-smoke decodes through its window of
    16 (the other archs have no window).  Logits and the cache within 2e-4."""
    jcfg, tcfg = _smoke(arch)
    mesh = make_local_mesh(1, 1)
    pre_j = JC.ShapeConfig("prefill_32k", 40, 2, "prefill")
    pre_t = TC.ShapeConfig("prefill_32k", 40, 2, "prefill")
    jb_pre = JS.make_prefill_step(jcfg, mesh, pre_j)
    tb_pre = TS.make_prefill_step(tcfg, None, pre_t)
    _, jp = JS.init_model(jcfg, seed=4, max_seq=40)
    tp = _carry(jp)
    tokens = np.random.default_rng(31).integers(0, jcfg.vocab, (2, 20)).astype(np.int32)
    jl, jcache = jb_pre.fn(jp, {"tokens": jnp.asarray(tokens)})
    tl, tcache = tb_pre.fn(tp, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    dec_j = JC.ShapeConfig(shape_name, 40, 2, "decode")
    dec_t = TC.ShapeConfig(shape_name, 40, 2, "decode")
    jb_dec = JS.make_decode_step(jcfg, mesh, dec_j)
    tb_dec = TS.make_decode_step(tcfg, None, dec_t)
    window = TS.decode_window(tcfg, dec_t)
    if window:  # the windowed prefill's cache, for both
        jl, jcache = JDEC.prefill(jp, jcfg, {"tokens": jnp.asarray(tokens)}, 40, window=window)
        tl, tcache = TDEC.prefill(tp, tcfg, {"tokens": torch.from_numpy(tokens)}, 40,
                                  window=window)
        assert tcache["k"].shape[2] == window
    for seed in range(3):
        tb, jbatch = _batch(tcfg, dec_t, seed)
        jl, jcache = jb_dec.fn(jp, jcache, jbatch)
        tl, tcache = tb_dec.fn(tp, tcache, tb)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    for (path, t), j in zip(tree_paths(tcache), jax.tree_util.tree_leaves(jcache)):
        np.testing.assert_allclose(_np(t), _np(j), err_msg=path, **TOL)


def _tame(jp, jcfg):
    """wq and wk at std 1/sqrt(d_model): O(1) scores, so two correct
    implementations' grads agree (tests/test_torch_train.py)."""
    attn = dict(jp["blocks"]["attn"])
    for name, heads in (("wq", jcfg.n_heads), ("wk", jcfg.n_kv_heads)):
        attn[name] = attn[name] * np.sqrt(heads / jcfg.d_model)
    return dict(jp, blocks=dict(jp["blocks"], attn=attn))


@pytest.mark.parametrize("arch", ["gemma-2b"])
def test_train_bundle_matches_jax(arch):
    """``make_step`` on a train shape: the loss and grad norm of one step
    within 1e-5, and the new params within 2e-4 of their leaf's max, from
    the same (tamed) params and synthetic batch."""
    jcfg, tcfg = _smoke(arch)
    shape_j = JC.ShapeConfig("train_4k", 16, 2, "train")
    shape_t = TC.ShapeConfig("train_4k", 16, 2, "train")
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    from repro.optim import adamw as JA

    jbundle = JS.make_step(jcfg, make_local_mesh(1, 1), shape_j, opt_cfg=JA.AdamWConfig(**opt))
    tbundle = TS.make_step(tcfg, None, shape_t, opt_cfg=TA.AdamWConfig(**opt))
    _, jp = JS.init_model(jcfg, seed=5, max_seq=16)
    jp = _tame(jp, jcfg)
    tp = _carry(jp)
    tb, jb = _batch(tcfg, shape_t, 6)
    jnew, _, jm = jbundle.fn(jp, JA.adamw_init(jp), jb)
    tnew, _, tm = tbundle.fn(tp, TA.adamw_init(tp), tb)
    for key in ("loss", "grad_norm"):
        assert abs(float(tm[key]) - float(jm[key])) <= 1e-5 * abs(float(jm[key])), key
    for (path, t), j in zip(tree_paths(tnew), jax.tree_util.tree_leaves(jnew)):
        j = np.asarray(j, np.float32)
        assert np.abs(_np(t) - j).max() <= 2e-4 * np.abs(j).max(), path


def test_synthetic_batch_is_seeded():
    cfg = TC.get_smoke_config("whisper-large-v3")
    shape = TC.ShapeConfig("t", 16, 2, "train")
    a, b = (TS.make_synthetic_batch(cfg, shape, seed=7, device="cpu") for _ in range(2))
    c = TS.make_synthetic_batch(cfg, shape, seed=8, device="cpu")
    assert list(a) == list(TS.batch_specs(cfg, shape))
    for key in a:
        assert torch.equal(a[key], b[key])
        assert _shape_dtype(a[key]) == _shape_dtype(TS.batch_specs(cfg, shape)[key])
    assert not torch.equal(a["tokens"], c["tokens"]) and bool((a["mask"] == 1).all())
    assert int(a["tokens"].min()) >= 0 and int(a["tokens"].max()) < cfg.vocab


# -- the step counter -----------------------------------------------------------------------


def _dense_matmul_flops(cfg, b, s, kind):
    """The matmul FLOPs of a dense (geglu / swiglu) decoder's step, counted
    here from its widths: per token and layer the q, k, v and o projections,
    q.k and p.v over all S keys (the plain path computes the whole square),
    the MLP's three products; the unembedding.  Training: the forward, the
    backward (2x), and (remat) each block recomputed in the backward up
    to its last saved input (PyTorch's checkpoint stops there, so the MLP's
    down projection is not run again)."""
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    proj = 2 * d * hd * (hq + 2 * hkv) + 2 * hq * hd * d
    attn = 4 * hq * hd * s
    down = 2 * cfg.d_ff * d
    layer = proj + attn + 2 * down + down
    unembed = 2 * d * cfg.vocab
    if kind == "prefill":  # the last token alone is unembedded
        return b * s * cfg.n_layers * layer + b * unembed
    per_layer = 3 * layer + (layer - down)
    return b * s * (cfg.n_layers * per_layer + 3 * unembed)


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_counted_flops_equal_the_matmuls(kind):
    """gemma-smoke on meta: the counter's FLOPs are the matmuls', exactly."""
    cfg = TC.get_smoke_config("gemma-2b")
    shape = TC.ShapeConfig("x", 24, 2, kind)
    cost = TDRY.count_cell(cfg, shape)
    assert cost.flops == _dense_matmul_flops(cfg, 2, 24, kind)
    assert cost.kernel_calls == {} and cost.total_bytes > 0


@pytest.mark.parametrize("arch,kind", [("gemma-2b", "train"), ("gemma-2b", "prefill"),
                                       ("gemma-2b", "decode"), ("xlstm-125m", "train"),
                                       ("phi-3-vision-4.2b", "train")])
def test_counter_on_meta_equals_a_cpu_run(arch, kind):
    """The same step counted on ``meta`` and run for real on the CPU: the
    same peak live bytes (inputs included), FLOPs and bytes."""
    cfg = TC.get_smoke_config(arch)
    shape = TC.ShapeConfig("x", 24 + cfg.n_img_tokens, 2, kind)
    bundle = TS.make_step(cfg, None, shape)
    meta = TDRY.count_cell(cfg, shape)
    _, params = TS.init_model(cfg, seed=0, max_seq=shape.seq_len, device="cpu")
    real = {"params": params, "batch": TS.make_synthetic_batch(cfg, shape, 0, device="cpu"),
            "opt_state": TA.adamw_init(params),
            "cache": TDEC.init_cache(cfg, 2, shape.seq_len, device="cpu")}
    real = {k: real[k] for k in bundle.input_specs}
    with TAN.StepCost(real, device="cpu") as cpu:
        out = bundle.fn(**real)
    del out
    assert cpu.input_bytes == meta.input_bytes
    assert cpu.peak == meta.peak > meta.input_bytes
    assert cpu.flops == meta.flops
    assert cpu.total_bytes == meta.total_bytes


def test_counter_tracks_storages_not_views():
    """A view adds no live bytes; freeing the last view frees the storage;
    an in-place op moves bytes but allocates nothing."""
    base = torch.empty(1024, device="meta")
    with TAN.StepCost([base]) as cost:
        assert cost.live == 4096
        a = torch.ones(256, 4, device="meta")  # 4096 B
        v = a[:128].view(-1)
        assert cost.live == 8192
        del a
        assert cost.live == 8192  # v holds the storage
        v.add_(1.0)
        assert cost.live == 8192
        del v
        assert cost.live == 4096
        b = base * 2  # reads 4 KiB, writes 4 KiB
    assert cost.peak == 8192 and b.shape == (1024,)
    assert cost.nbytes == 4096 + (2048 + 2048) + (4096 + 4096)  # ones; add_; mul


KERNEL_CALLS = {
    # name: (meta inputs, (analytic FLOPs, bytes) written out here, output shapes)
    "flash_attention": (lambda: [torch.empty(2, 40, 8, 64, dtype=torch.bfloat16, device="meta"),
                                 torch.empty(2, 40, 2, 64, dtype=torch.bfloat16, device="meta"),
                                 torch.empty(2, 40, 2, 64, dtype=torch.bfloat16, device="meta")],
                        (4 * 2 * 8 * 64 * 40 * 41 / 2, 2 * (2 * 2 * 40 * 8 * 64 + 2 * 2 * 40 * 2 * 64)),
                        [(2, 40, 8, 64)]),
    "decode_attention": (lambda: [torch.empty(2, 1, 8, 64, dtype=torch.bfloat16, device="meta"),
                                  torch.empty(2, 96, 2, 64, dtype=torch.bfloat16, device="meta"),
                                  torch.empty(2, 96, 2, 64, dtype=torch.bfloat16, device="meta"),
                                  torch.empty(2, dtype=torch.int32, device="meta")],
                         (4 * 2 * 8 * 96 * 64, 2 * (2 * 2 * 8 * 64 + 2 * 2 * 96 * 2 * 64) + 8),
                         [(2, 1, 8, 64)]),
    "ssm_scan": (lambda: [torch.empty(2, 40, 32, 16, device="meta"),
                          torch.empty(2, 40, 32, 16, device="meta"),
                          torch.empty(2, 40, 16, device="meta")],
                 (4 * 2 * 40 * 32 * 16,
                  4 * (2 * 2 * 40 * 32 * 16 + 2 * 40 * 16 + 2 * 40 * 32 + 2 * 32 * 16)),
                 [(2, 40, 32), (2, 32, 16)]),
    "ssm_scan_fused": (lambda: [torch.empty(2, 40, 32, device="meta"),
                                torch.empty(2, 40, 16, device="meta"),
                                torch.empty(2, 40, 16, device="meta"),
                                torch.empty(2, 40, 32, device="meta"),
                                torch.empty(32, 16, device="meta")],
                       (7 * 2 * 40 * 32 * 16,
                        4 * (2 * 2 * 40 * 32 + 2 * 2 * 40 * 16 + 32 * 16 + 2 * 40 * 32
                             + 2 * 32 * 16)),
                       [(2, 40, 32), (2, 32, 16)]),
}


@pytest.mark.parametrize("name", list(KERNEL_CALLS))
def test_kernel_on_meta_counts_no_launch_and_charges_its_cost(name):
    make, (flops, nbytes), shapes = KERNEL_CALLS[name]
    args = make()
    kops.reset_launches()
    with TAN.StepCost(args) as cost:
        out = kops.KERNELS[name](*args)
    assert kops.launches() == dict.fromkeys(kops.KERNELS, 0)
    assert cost.kernel_calls == {name: 1}
    assert (cost.kernel_flops, cost.kernel_bytes) == (flops, nbytes)
    assert kops.kernel_cost(name, *args) == (flops, nbytes)
    outs = [out] if isinstance(out, torch.Tensor) else list(out)
    assert [tuple(t.shape) for t in outs] == shapes
    assert all(t.device.type == "meta" for t in outs)
    assert outs[0].dtype == args[0].dtype
    with pytest.raises(ValueError):  # the kernel's contract holds on meta too
        kops.KERNELS[name](*([args[0][:1]] + args[1:]))


def test_hymba_prefill_on_meta_reaches_k3_under_the_perf_override():
    """The reference's prefill_32k override for hymba (blockwise attention,
    the chunked scan): each of its layers calls K3 once, on meta."""
    over = TDRY._perf_overrides()[("hymba-1.5b", "prefill_32k")]
    cfg = TC.get_smoke_config("hymba-1.5b", **over)
    cost = TDRY.count_cell(cfg, TC.ShapeConfig("prefill_32k", 40, 1, "prefill"))
    assert cost.kernel_calls == {"ssm_scan_fused": cfg.n_layers}


def test_granite_train_cell_under_perf_fails_naming_item_5(monkeypatch, capsys, tmp_path):
    """The reference's perf override of granite-moe's ``train_4k``
    (``ep_gather`` with 48 padded experts, blockwise attention partitioned
    over the sequence), which the port refused until expert parallelism was
    ported, now counts on ``meta``: granite-moe-smoke under it on a fake (2,
    4) group, whose "model" divides the 48 experts, with one reduction over
    "model" of the MoE's output a layer; then the CLI with ``--perf`` on the
    16 x 16 mesh (the smoke config at a cut shape) exits 0 and writes its
    record."""
    from torch.distributed.device_mesh import init_device_mesh

    over = TDRY._perf_overrides()[("granite-moe-3b-a800m", "train_4k")]
    assert over["moe"].routing_impl == "ep_gather" and over["moe"].e_pad == 48
    cfg = TC.get_smoke_config("granite-moe-3b-a800m", **over)
    with TDRY.fake_world(8):
        mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
        cost = TDRY.count_cell(cfg, TC.ShapeConfig("train_4k", 32, 4, "train"), mesh)
    assert cost.flops > 0 and cost.collectives()["counts"].get("all-reduce", 0) >= cfg.n_layers
    monkeypatch.setattr(TDRY, "get_config", TC.get_smoke_config)
    monkeypatch.setitem(TDRY.SHAPES, "train_4k", TC.ShapeConfig("train_4k", 32, 16, "train"))
    monkeypatch.setattr(sys, "argv", ["dryrun", "--arch", "granite-moe-3b-a800m", "--shape",
                                      "train_4k", "--perf", "--out", str(tmp_path)])
    TDRY.main()
    assert "ALL DRY-RUN CELLS OK" in capsys.readouterr().out
    with open(tmp_path / "single" / "granite-moe-3b-a800m__train_4k.json") as f:
        rec = json.load(f)
    assert rec["mesh"] == "16x16" and rec["n_chips"] == 256 and rec["flops_per_dev"] > 0


# -- the one-device record, in a subprocess --------------------------------------------------

SCRIPT = r"""
import json, resource, sys
import torch
from repro_torch.configs.base import SHAPES, get_config
from repro_torch.launch.dryrun import account, default_strategy
out = {}
for arch, shape in [("gemma-2b", "train_4k"), ("granite-3-8b", "decode_32k"),
                    ("phi3-mini-3.8b", "train_4k"), ("xlstm-125m", "long_500k"),
                    ("nemotron-4-340b", "train_4k")]:
    out[f"{arch} {shape}"] = account(arch, get_config(arch), SHAPES[shape],
                                     default_strategy(arch, shape), verbose=False, mesh=None)
out["maxrss_kib"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
out["cuda_initialized"] = torch.cuda.is_initialized()
print("RESULT " + json.dumps(out))
"""
# the reference's record keys (src/repro/launch/dryrun.py::run_cell), and the
# port's names for those that named XLA's compile or its HLO
REF_KEYS = {"arch", "shape", "mesh", "strategy", "kind", "n_chips", "compile_s", "accounting",
            "hlo_flops_per_dev", "hlo_bytes_per_dev", "scanned_flops_per_dev", "collectives",
            "collectives_scanned", "memory", "roofline", "model_flops_global",
            "model_flops_per_dev", "useful_flops_ratio", "hbm_fit", "n_params",
            "n_active_params"}
RENAMED = {"compile_s": "count_s", "hlo_flops_per_dev": "flops_per_dev",
           "hlo_bytes_per_dev": "bytes_per_dev"}
SMOKE_CELLS = ["gemma-2b train_4k", "granite-3-8b decode_32k", "phi3-mini-3.8b train_4k",
               "xlstm-125m long_500k"]


@pytest.fixture(scope="module", autouse=True)
def dryrun_process():
    """The subprocess starts with the module's first test and runs beside
    the others; ``records`` waits for it."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.Popen([sys.executable, "-c", SCRIPT], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)
    yield proc
    proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def records(dryrun_process):
    out, err = dryrun_process.communicate(timeout=300)
    assert dryrun_process.returncode == 0, f"stdout:\n{out[-3000:]}\nstderr:\n{err[-3000:]}"
    line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")][0]
    return json.loads(line[7:])


@pytest.mark.parametrize("cell", SMOKE_CELLS)
def test_run_cell_record(records, cell):
    rec = records[cell]
    want = {RENAMED.get(k, k) for k in REF_KEYS}
    assert want <= set(rec), want - set(rec)
    assert rec["n_chips"] == 1 and rec["mesh"] == "1"
    assert f"{rec['arch']} {rec['shape']}" == cell
    assert {"compute_s", "memory_s", "collective_s", "collective_wire_s", "dominant",
            "roofline_fraction"} <= set(rec["roofline"])
    assert rec["roofline"]["dominant"] in ("compute_s", "memory_s")
    assert rec["collectives"]["total_operand"] == 0 == rec["roofline"]["collective_s"]
    assert rec["flops_per_dev"] > 0 and rec["bytes_per_dev"] > 0
    assert rec["memory"]["peak_bytes_per_device"] >= rec["memory"]["argument_size_in_bytes"] > 0
    cfg = TC.get_config(rec["arch"])
    assert rec["model_flops_global"] == TAN.model_flops(cfg, TC.SHAPES[rec["shape"]])


def test_run_cell_gemma_train_flops_are_its_matmuls(records):
    """gemma-2b train_4k (B = 256, S = 4096, remat): the counted FLOPs within
    2% of the matmuls counted from its widths."""
    rec = records["gemma-2b train_4k"]
    cfg = TC.get_config("gemma-2b")
    want = _dense_matmul_flops(cfg, 256, 4096, "train")
    assert abs(rec["flops_per_dev"] - want) <= 0.02 * want
    assert rec["strategy"] == "tp"


def test_run_cell_allocates_nothing(records):
    """Terabytes of live tensors on meta, in a process that stayed under 3
    GiB of host memory and never initialised CUDA."""
    assert records["nemotron-4-340b train_4k"]["memory"]["peak_bytes_per_device"] > 2**40
    assert records["maxrss_kib"] < 3 * 2**20
    assert records["cuda_initialized"] is False


def test_run_cell_nemotron_train_does_not_fit(records):
    rec = records["nemotron-4-340b train_4k"]
    assert rec["hbm_fit"] is False and rec["strategy"] == "fsdp_tp"
    # its bf16 params alone are 8x the card
    assert rec["memory"]["argument_size_in_bytes"] > 8 * 80 * 2**30
