"""The port's sharding rules against the JAX package's, on the CPU.

For every arch (full size), both strategies and the meshes (1, 1), (2, 2),
(1, 4), (16, 16) and the pod (2, 16, 16): ``param_pspecs``,
``batch_pspecs`` (the four shapes), ``cache_pspecs`` (the decode shapes,
with ``long_500k``'s window, ``decode_seq_shard`` on and off) and the
optimizer state's ``opt_pspecs`` (ZeRO-1 on and off), entry by entry.  The JAX side runs on ``jax.sharding.AbstractMesh``, the port's on a
plain ``{name: size}`` layout: neither needs a device.  Then the conversion
of a spec to DTensor placements.
"""
import jax
import pytest
from jax.sharding import AbstractMesh
from torch.distributed.tensor import Replicate, Shard

from repro import sharding as JSH
from repro import steps as JS
from repro.configs import base as JC
from repro.models import decoding as JDEC
from repro.models import transformer as JTF
from repro.optim import adamw as JA
from repro_torch import sharding as TSH
from repro_torch import steps as TS
from repro_torch.configs import base as TC
from repro_torch.models import decoding as TDEC
from repro_torch.models import transformer as TTF
from repro_torch.models.params import tree_paths
from repro_torch.optim import adamw as TA

import _torch_threads  # noqa: F401  (one intra-op thread per test worker)

MESHES = {"1x1": (("data", "model"), (1, 1)), "2x2": (("data", "model"), (2, 2)),
          "1x4": (("data", "model"), (1, 4)), "16x16": (("data", "model"), (16, 16)),
          "pod": (("pod", "data", "model"), (2, 16, 16))}


def _meshes(name):
    names, sizes = MESHES[name]
    return AbstractMesh(sizes, names), dict(zip(names, sizes))


def _entries(spec):
    return tuple(spec)


def _jax_leaves(tree):
    return jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))


def _assert_same(tspecs, jspecs):
    tl = [(path, _entries(p)) for path, p in tree_paths(tspecs)]
    jl = [_entries(p) for p in _jax_leaves(jspecs)]
    assert len(tl) == len(jl)
    for (path, t), j in zip(tl, jl):
        assert t == j, f"{path}: port {t}, JAX {j}"


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("strategy", ["tp", "fsdp_tp"])
@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_param_pspecs_match_jax(arch, strategy, mesh):
    jmesh, tmesh = _meshes(mesh)
    jcfg, tcfg = JC.get_config(arch), TC.get_config(arch)
    jdefs, tdefs = JTF.model_defs(jcfg, max_seq=4096), TTF.model_defs(tcfg, max_seq=4096)
    _assert_same(TSH.param_pspecs(tdefs, TSH.make_rules(tmesh, strategy), tmesh),
                 JSH.param_pspecs(jdefs, JSH.make_rules(jmesh, strategy), jmesh))


@pytest.mark.parametrize("zero1", [True, False], ids=["zero1", "no_zero1"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("strategy", ["tp", "fsdp_tp"])
@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_opt_pspecs_match_jax(arch, strategy, mesh, zero1):
    jmesh, tmesh = _meshes(mesh)
    jdefs = JTF.model_defs(JC.get_config(arch), max_seq=4096)
    tdefs = TTF.model_defs(TC.get_config(arch), max_seq=4096)
    tspecs = TA.opt_pspecs(tdefs, TSH.make_rules(tmesh, strategy), tmesh, zero1=zero1)
    jspecs = JA.opt_pspecs(jdefs, JSH.make_rules(jmesh, strategy), jmesh, zero1=zero1)
    assert sorted(tspecs) == sorted(jspecs) == ["mu", "nu", "step"]
    _assert_same(tspecs, jspecs)


@pytest.mark.parametrize("shape,base,mesh,want", [
    # no free dp axis: "data" already shards the param
    ((64, 32), ("data", "model"), {"data": 2, "model": 2}, ("data", "model")),
    # no unsharded dim that "data" divides
    ((3, 5), (None, None), {"data": 2, "model": 2}, (None, None)),
    ((3, 32), (None, "model"), {"data": 4, "model": 2}, (None, "model")),
    # the first divisible unsharded dim, past a short spec
    ((3, 8, 16), (None,), {"data": 4, "model": 2}, (None, "data", None)),
    # both dp axes of the pod mesh free: one tuple entry
    ((64, 32), (None, "model"), {"pod": 2, "data": 16, "model": 16}, (("pod", "data"), "model")),
    # "pod" taken by the param: "data" alone
    ((64, 32), ("pod", None), {"pod": 2, "data": 16, "model": 16}, ("pod", "data")),
    # a size-1 data axis divides every dim
    ((3,), (None,), {"data": 1, "model": 4}, ("data",)),
])
def test_zero1_spec_matches_jax(shape, base, mesh, want):
    names, sizes = tuple(mesh), tuple(mesh.values())
    got = TA._zero1_spec(shape, TSH.P(*base), mesh)
    assert _entries(got) == _entries(JA._zero1_spec(shape, jax.sharding.PartitionSpec(*base),
                                                    AbstractMesh(sizes, names)))
    assert got == TSH.P(*want)


@pytest.mark.parametrize("zero1", [True, False], ids=["zero1", "no_zero1"])
@pytest.mark.parametrize("strategy", ["tp", "fsdp_tp"])
@pytest.mark.parametrize("arch", ["gemma-2b", "hymba-1.5b"])
def test_train_bundle_shardings_match_jax(arch, strategy, zero1):
    """``make_train_step(...).in_shardings`` / ``out_shardings`` on (2, 2)
    equal the reference bundle's on an abstract (2, 2) mesh."""
    jmesh, tmesh = _meshes("2x2")
    shape = ("t", 32, 4, "train")
    tb = TS.make_train_step(TC.get_smoke_config(arch), tmesh, TC.ShapeConfig(*shape),
                            strategy=strategy, zero1=zero1)
    jb = JS.make_train_step(JC.get_smoke_config(arch), jmesh, JC.ShapeConfig(*shape),
                            strategy=strategy, zero1=zero1)
    assert len(tb.in_shardings) == len(jb.in_shardings) == 3
    for tpart, jpart in zip(tb.in_shardings + tb.out_shardings,
                            jb.in_shardings + jb.out_shardings):
        if jpart is None:
            assert tpart is None
        else:
            _assert_same(tpart, jpart)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "whisper-large-v3"])
def test_train_bundle_of_a_family_not_on_a_mesh_raises(arch):
    """No family is left off a mesh: the moe and encdec train bundles'
    shardings on (2, 2) under ``fsdp_tp`` with ZeRO-1 (the experts over
    "model", whisper's position tables over "data") equal the reference
    bundle's."""
    jmesh, tmesh = _meshes("2x2")
    shape = ("t", 32, 4, "train")
    tb = TS.make_train_step(TC.get_smoke_config(arch), tmesh, TC.ShapeConfig(*shape),
                            strategy="fsdp_tp")
    jb = JS.make_train_step(JC.get_smoke_config(arch), jmesh, JC.ShapeConfig(*shape),
                            strategy="fsdp_tp")
    for tpart, jpart in zip(tb.in_shardings + tb.out_shardings,
                            jb.in_shardings + jb.out_shardings):
        if jpart is None:
            assert tpart is None
        else:
            _assert_same(tpart, jpart)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("shape", list(TC.SHAPES))
@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_batch_pspecs_match_jax(arch, shape, mesh):
    jmesh, tmesh = _meshes(mesh)
    tspecs = TSH.batch_pspecs(TS.batch_specs(TC.get_config(arch), TC.SHAPES[shape]), tmesh)
    jspecs = JSH.batch_pspecs(JS.batch_specs(JC.get_config(arch), JC.SHAPES[shape]), jmesh)
    assert list(tspecs) == list(jspecs)
    for key in jspecs:
        assert _entries(tspecs[key]) == _entries(jspecs[key]), key


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("seq_shard", [False, True], ids=["heads", "seq"])
@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_cache_pspecs_match_jax(arch, shape, seq_shard, mesh):
    """At the cell's batch and length, with the decode bundle's window
    (``long_500k`` on an arch that has one)."""
    jmesh, tmesh = _meshes(mesh)
    jcfg = JC.get_config(arch, decode_seq_shard=seq_shard)
    tcfg = TC.get_config(arch, decode_seq_shard=seq_shard)
    sh = TC.SHAPES[shape]
    window = TS.decode_window(tcfg, sh)
    tspecs = TSH.cache_pspecs(tcfg, TDEC.cache_specs(tcfg, sh.global_batch, sh.seq_len, window),
                              tmesh)
    jspecs = JSH.cache_pspecs(jcfg, JDEC.cache_specs(jcfg, sh.global_batch, sh.seq_len, window),
                              jmesh)
    assert sorted(tspecs) == sorted(jspecs)
    _assert_same(tspecs, jspecs)


@pytest.mark.parametrize("arch", ["gemma-2b", "hymba-1.5b", "granite-moe-3b-a800m",
                                  "phi-3-vision-4.2b", "whisper-large-v3", "xlstm-125m"])
def test_bundle_shardings_match_jax(arch):
    """The prefill and decode bundles' ``in_shardings`` / ``out_shardings``
    on (2, 2) equal the reference bundles' on an abstract (2, 2) mesh, for
    every family."""
    jmesh, tmesh = _meshes("2x2")
    tcfg, jcfg = TC.get_smoke_config(arch), JC.get_smoke_config(arch)
    for kind in ("prefill", "decode"):
        tshape, jshape = TC.ShapeConfig(kind, 32, 4, kind), JC.ShapeConfig(kind, 32, 4, kind)
        jb = JS.make_step(jcfg, jmesh, jshape)
        tb = TS.make_step(tcfg, tmesh, tshape)
        for tpart, jpart in zip(tb.in_shardings + tb.out_shardings,
                                jb.in_shardings + jb.out_shardings):
            if jpart is None:
                assert tpart is None
            else:
                _assert_same(tpart, jpart)


def test_rules_on_a_production_layout():
    """The rules read names and sizes only: gemma-2b's MQA cache on the
    (16, 16) layout shards head_dim over "model", its q heads (8) do not
    divide 16 and stay whole, and the pod layout puts the batch over
    ("pod", "data")."""
    cfg = TC.get_config("gemma-2b")
    mesh = {"data": 16, "model": 16}
    specs = TSH.cache_pspecs(cfg, TDEC.cache_specs(cfg, 128, 32768), mesh)
    assert specs["k"] == TSH.P(None, "data", None, None, "model")
    pod = {"pod": 2, "data": 16, "model": 16}
    assert TSH.batch_pspecs(TS.batch_specs(cfg, TC.SHAPES["prefill_32k"]), pod)["tokens"] \
        == TSH.P(("pod", "data"), None)
    wq = TSH.param_pspecs(TTF.model_defs(cfg), TSH.make_rules(mesh), mesh)["blocks"]["attn"]["wq"]
    assert wq == TSH.P(None, None, None, None)


@pytest.mark.parametrize("spec,want", [
    (("model", None), (Replicate(), Shard(0))),
    ((None, "data"), (Shard(1), Replicate())),
    ((("data", "model"), None), (Shard(0), Shard(0))),
    ((None, None), (Replicate(), Replicate())),
    (("data", "model"), (Shard(0), Shard(1))),
])
def test_placements_of_a_spec(spec, want):
    """``Shard(d)`` on each mesh dim named in entry d, ``Replicate()``
    elsewhere; a tuple entry shards its dim over several mesh dims."""
    assert TSH.placements(TSH.P(*spec), {"data": 2, "model": 2}) == want


def test_placements_refuse_a_tuple_out_of_mesh_order():
    with pytest.raises(ValueError, match="mesh order"):
        TSH.placements(TSH.P(("model", "data")), {"data": 2, "model": 2})


def test_to_shardings_keeps_the_tree():
    cfg = TC.get_smoke_config("hymba-1.5b")
    mesh = {"data": 2, "model": 2}
    specs = TSH.cache_pspecs(cfg, TDEC.cache_specs(cfg, 4, 32), mesh)
    pl = TSH.to_shardings(specs, mesh)
    assert sorted(pl) == sorted(specs)
    assert pl["ssm"] == (Shard(1), Shard(2)) and pl["pos"] == (Replicate(), Replicate())
    assert pl["k"] == (Shard(1), Shard(3))  # hymba-smoke's 2 kv heads divide "model"
    params = TSH.param_shardings(TTF.model_defs(cfg), TSH.make_rules(mesh, "fsdp_tp"), mesh)
    assert params["blocks"]["attn"]["wq"] == (Shard(1), Shard(2))  # (L, embed, heads, D)


def test_a_size_one_mesh_dim_is_replicated():
    """One rank holds the whole dim; DTensor's view rules refuse a shard there."""
    assert TSH.placements(TSH.P("data", "model"), {"data": 1, "model": 2}) \
        == (Replicate(), Shard(1))
    assert TSH.placements(TSH.P(None, "model"), {"data": 1, "model": 1}) \
        == (Replicate(), Replicate())
