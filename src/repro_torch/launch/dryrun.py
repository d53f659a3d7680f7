"""The dry-run (port of ``repro.launch.dryrun``): for each (architecture x
input shape) cell, its step run once on ``meta`` tensors, which allocate
nothing and compute nothing, with its FLOPs, bytes, peak live bytes and
collectives counted for one device (``launch/analysis.py::StepCost``) and
set against one H100's roofline.  No card and no CPU work is needed: being
device-free is the dry-run's nature, as the reference's forced host devices
are.

By default a cell is counted on the reference's production mesh, 16 x 16
(``--multi-pod``: 2 x 16 x 16; ``--both-meshes``: each in turn), as one
device of it sees the step.  The counterpart of the reference's 512 forced
host devices is a ``"fake"`` process group of the mesh's size in this one
process (``fake_world``), rank 0 of which runs the step: its inputs are
``meta`` DTensors holding rank 0's shards (``place_zeros``), which is the
largest where a dim does not divide its axis, and every collective DTensor
issues is counted, not run.  Under ``tp`` the 2 x 16 x 16 mesh is counted
on its (32, 16) view (``tp_view``).  ``account(..., mesh=None)`` counts the
step on one device with no group at all.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out DIR]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes [--perf]
  ... [--strategy {tp,fsdp_tp}]

Records go to ``OUT/single/`` (16 x 16) and ``OUT/multi/`` (2 x 16 x 16).

Differences from the reference:
- No compile, so ``compile_s`` is ``count_s``, the meta run's time, and the
  keys that named HLO are ``flops_per_dev`` and ``bytes_per_dev``; the
  collectives' bytes are not in ``bytes_per_dev``.
- XLA's cost analysis visits a scan body once, so the reference compiles
  L = 1 and L = 2 probes and extrapolates the per-layer cost.  An eager
  count on ``meta`` sees every layer, so every arch is counted directly
  and there is no probe (``scanned_flops_per_dev`` equals
  ``flops_per_dev``, ``collectives_scanned`` equals ``collectives``).
- ``--perf`` applies the reference's overrides whole (granite-moe's
  ``train_4k`` one runs ``routing_impl="ep_gather"``, ``parallel/ep.py``).
- The fake group lives in ``torch.testing._internal``; where a torch lacks
  it the dry-run on a mesh raises rather than counting on one device.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

from repro_torch import sharding as SH
from repro_torch.configs.base import ARCH_IDS, SHAPES, ModelConfig, ShapeConfig, cells, get_config
from repro_torch.launch.analysis import StepCost, model_flops, no_collectives, roofline_terms
from repro_torch.launch.mesh import HW, make_production_mesh
from repro_torch.steps import make_step

# per-arch strategy of the reference's train cells: 2-D weight sharding
# where TP alone cannot fit
TRAIN_STRATEGY = {
    "nemotron-4-340b": "fsdp_tp",
}


def _perf_overrides() -> Dict[Any, Dict[str, Any]]:
    """The reference's perf-config overrides, keyed by (arch, shape)."""
    gm = get_config("granite-moe-3b-a800m")
    hy = get_config("hymba-1.5b")
    return {
        ("granite-moe-3b-a800m", "train_4k"): {
            "moe": dataclasses.replace(gm.moe, routing_impl="ep_gather", n_experts_padded=48),
            "attention_impl": "blockwise",
            "attention_partitioning": "seq",
        },
        ("hymba-1.5b", "prefill_32k"): {
            "attention_partitioning": "seq",
            "attention_impl": "blockwise",
            "ssm": dataclasses.replace(hy.ssm, scan_impl="chunked", chunk=1024),
        },
        ("gemma-2b", "train_4k"): {
            "attention_partitioning": "seq",
        },
    }


def default_strategy(arch: str, shape_name: str) -> str:
    if SHAPES[shape_name].kind == "train":
        return TRAIN_STRATEGY.get(arch, "tp")
    return "tp"


@contextlib.contextmanager
def fake_world(n: int):
    """A ``"fake"`` process group of ``n`` ranks in this process, this process
    rank 0, for the dry-run's mesh: collectives over it are counted, never
    sent.  A fake group of ``n`` ranks already up is reused and left up;
    otherwise the group is started here and destroyed at exit.  Raises if
    another group is up, or if this torch has no fake group."""
    import torch.distributed as dist

    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError("the dry-run on a mesh needs torch's fake process group "
                           "(torch.testing._internal.distributed.fake_pg)") from e
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == n:
            yield
            return
        raise RuntimeError(f"the dry-run needs a fake group of {n} ranks; a "
                           f"{dist.get_backend()!r} group of {dist.get_world_size()} is up")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def place_zeros(tree, mesh, spec_tree, device="meta"):
    """DTensors of zeros for the tensors of ``tree`` (shapes and dtypes),
    placed on ``mesh`` by the specs of ``spec_tree``, each holding this
    rank's shard on ``device`` (rank 0's is the largest where a dim does
    not divide its axis).  Nothing is sent: ``sharding.distribute`` would
    scatter from rank 0 and count a collective that is no part of the
    step."""
    return SH.tree_map(lambda t, p: SH.filled(t.shape, 0, t.dtype, device, mesh,
                                              SH.placements(p, mesh)), tree, spec_tree)


def count_cell(cfg: ModelConfig, shape: ShapeConfig, mesh=None,
               strategy: str = "tp") -> StepCost:
    """The cell's step (``make_step``, remat on for training) run once on its
    ``meta`` input specs under a ``StepCost``: on one device with
    ``mesh=None``, else as one rank of ``mesh`` (a ``DeviceMesh``) with the
    inputs placed by the bundle's ``in_shardings`` under ``strategy``."""
    bundle = make_step(cfg, mesh, shape, strategy=strategy)
    inputs = bundle.input_specs
    if mesh is not None:
        inputs = place_zeros(inputs, mesh, dict(zip(inputs, bundle.in_shardings)))
    with StepCost(inputs) as cost:
        out = bundle.fn(**inputs)
    cost.output_bytes = cost.live - cost.input_bytes
    del out
    return cost


def mesh_name(mesh) -> str:
    """"1" for one device, else the mesh's shape as "16x16"."""
    return "1" if mesh is None else "x".join(str(n) for n in mesh.shape)


def account(arch: str, cfg: ModelConfig, shape: ShapeConfig, strategy: str,
            verbose: bool = True, mesh=None, name: Optional[str] = None) -> Dict[str, Any]:
    """The dry-run record of ``cfg`` (arch ``arch``) at ``shape``, any
    ``ShapeConfig`` (a cell's, or one cut to size): per device of ``mesh``
    (a ``DeviceMesh``), or of one device with ``mesh=None``.  ``name`` is the
    record's mesh where ``mesh`` stands for another (``tp_view``)."""
    name = name or mesh_name(mesh)
    t0 = time.time()
    cost = count_cell(cfg, shape, mesh, strategy)
    count_s = time.time() - t0
    coll = no_collectives() if mesh is None else cost.collectives()
    n_chips = 1 if mesh is None else mesh.size()
    terms = roofline_terms(cost.flops, cost.total_bytes, coll)
    mf = model_flops(cfg, shape)
    mem = {"argument_size_in_bytes": cost.input_bytes,
           "output_size_in_bytes": cost.output_bytes,
           "peak_bytes_per_device": cost.peak}
    record = {
        "arch": arch, "shape": shape.name, "mesh": name, "strategy": strategy,
        "kind": shape.kind, "n_chips": n_chips, "count_s": round(count_s, 2),
        "accounting": {"mode": "direct", "note": "eager count on meta: every layer seen",
                       "counted_on": mesh_name(mesh)},
        "flops_per_dev": cost.flops,
        "bytes_per_dev": cost.total_bytes,
        "scanned_flops_per_dev": cost.flops,
        "kernel_calls": cost.kernel_calls,
        "kernel_flops": cost.kernel_flops,
        "kernel_bytes": cost.kernel_bytes,
        "collectives": coll,
        "collectives_scanned": dict(coll),
        "memory": mem,
        "roofline": terms,
        "model_flops_global": mf,
        "model_flops_per_dev": mf / n_chips,
        "useful_flops_ratio": mf / n_chips / cost.flops if cost.flops else None,
        "hbm_fit": cost.peak <= HW["hbm_bytes"],
        "n_params": cfg.n_params(),
        "n_active_params": cfg.n_active_params(),
        "global_batch": shape.global_batch, "seq_len": shape.seq_len,
    }
    if verbose:
        print(f"[dryrun] {arch:24s} {shape.name:12s} {record['mesh']:8s} "
              f"B={shape.global_batch:<4d} {strategy:8s} "
              f"count={count_s:6.1f}s flops/dev={cost.flops:.3e} "
              f"bytes/dev={cost.total_bytes:.3e} coll={coll['total_operand']:.3e}B "
              f"peakmem={cost.peak / 2**30:.2f}GiB dominant={terms['dominant']} "
              f"bound={terms['bound_s'] * 1e3:.2f}ms "
              f"useful={record['useful_flops_ratio'] or 0:.2f}", flush=True)
    return record


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             strategy: Optional[str] = None, overrides: Optional[Dict] = None,
             verbose: bool = True) -> Dict[str, Any]:
    """The record of the cell (arch, shape_name) of ``configs.base.cells``,
    with the config's ``overrides``, per device of the production mesh
    (16 x 16, or 2 x 16 x 16 with ``multi_pod``) over a ``fake_world``."""
    cfg = get_config(arch, **dict(overrides or {}))
    strategy = strategy or default_strategy(arch, shape_name)
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        name = mesh_name(mesh)
        if multi_pod and strategy == "tp":
            mesh = tp_view(mesh)
        return account(arch, cfg, SHAPES[shape_name], strategy, verbose=verbose, mesh=mesh,
                       name=name)


def tp_view(mesh):
    """The 2 x 16 x 16 mesh as the ``tp`` strategy uses it: a (32, 16) mesh
    with axes ("data", "model").  Under ``tp`` every spec names "pod" and
    "data" together (the batch, ZeRO-1's moments, the caches), so each
    device holds the same shards on either, and a reduction over both is one
    collective over 32 ranks, as XLA issues it.  On the 3-D mesh DTensor
    would issue two in turn, and its redistribute planner (torch 2.13) takes
    minutes for each new layout.  ``fsdp_tp`` shards "embed" over "data"
    alone, so it is counted on the 3-D mesh itself."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(mesh.device_type, (mesh.size(0) * mesh.size(1), mesh.size(2)),
                            mesh_dim_names=("data", "model"))


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--arch", choices=ARCH_IDS)
    p.add_argument("--shape", choices=list(SHAPES))
    p.add_argument("--all", action="store_true", help="every runnable cell")
    p.add_argument("--multi-pod", action="store_true", help="the 2x16x16 mesh")
    p.add_argument("--both-meshes", action="store_true", help="16x16, then 2x16x16")
    p.add_argument("--strategy", choices=["tp", "fsdp_tp"])
    p.add_argument("--out", default="artifacts/dryrun_torch")
    p.add_argument("--skip-existing", action="store_true")
    p.add_argument("--perf", action="store_true",
                   help="apply the reference's perf overrides where defined")
    args = p.parse_args()
    perf_map = _perf_overrides() if args.perf else {}
    if args.all:
        todo = [(arch, shape_name) for arch, shape_name, _ in cells()]
    elif args.arch and args.shape:
        todo = [(args.arch, args.shape)]
    else:
        p.error("--arch and --shape (or --all) required")
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = []
    for multi in meshes:
        mesh_tag = "multi" if multi else "single"
        with fake_world(512 if multi else 256):  # one group for the mesh's cells
            for arch, shape_name in todo:
                path = os.path.join(args.out, mesh_tag, f"{arch}__{shape_name}.json")
                if args.skip_existing and os.path.exists(path):
                    print(f"[dryrun] skip existing {path}")
                    continue
                try:
                    rec = run_cell(arch, shape_name, multi_pod=multi, strategy=args.strategy,
                                   overrides=perf_map.get((arch, shape_name)))
                except Exception as e:  # noqa: BLE001  (every cell is tried; failures listed)
                    traceback.print_exc()
                    failures.append((mesh_tag, arch, shape_name, f"{type(e).__name__}: {e}"))
                    continue
                os.makedirs(os.path.dirname(path), exist_ok=True)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
    if failures:
        print("\nFAILURES:")
        for f_ in failures:
            print(" ", f_)
        raise SystemExit(1)
    print("\nALL DRY-RUN CELLS OK")


if __name__ == "__main__":
    main()
