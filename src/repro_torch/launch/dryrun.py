"""The dry-run (port of ``repro.launch.dryrun``): for each (architecture x
input shape) cell, its step run once on ``meta`` tensors, which allocate
nothing and compute nothing, with its FLOPs, bytes and peak live bytes
counted (``launch/analysis.py::StepCost``) and set against one H100's
roofline.  No card and no CPU work is needed: being device-free is the
dry-run's nature, as the reference's forced host devices are.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--perf] [--out DIR]

Differences from the reference:
- One device: the record says ``n_chips`` 1; ``--multi-pod``,
  ``--both-meshes`` and the strategy's shardings wait for ROADMAP.md Queue 1
  item 5a-iv, and the collective statistics are zeros.
  ``strategy`` is recorded as the reference's default for the cell (or
  ``run_cell``'s argument); the CLI has no ``--strategy``, since on one
  device no choice changes the count.
- No compile, so ``compile_s`` is ``count_s``, the meta run's time, and the
  keys that named HLO are ``flops_per_dev`` and ``bytes_per_dev``.
- XLA's cost analysis visits a scan body once, so the reference compiles
  L = 1 and L = 2 probes and extrapolates the per-layer cost.  An eager
  count on ``meta`` sees every layer, so every arch is counted directly
  and there is no probe (``scanned_flops_per_dev`` equals
  ``flops_per_dev``).
- ``--perf`` applies the reference's overrides whole.  granite-moe's
  ``train_4k`` one asks for ``routing_impl="ep_gather"``, expert
  parallelism, which the port refuses until Queue 1 item 5b: that cell then
  fails with the refusal's message.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

from repro_torch.configs.base import ARCH_IDS, SHAPES, ModelConfig, ShapeConfig, cells, get_config
from repro_torch.launch.analysis import StepCost, model_flops, no_collectives, roofline_terms
from repro_torch.launch.mesh import HW
from repro_torch.steps import make_step

# per-arch strategy of the reference's train cells (recorded; one device
# shards nothing)
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


def count_cell(cfg: ModelConfig, shape: ShapeConfig) -> StepCost:
    """The cell's step (``make_step``, remat on for training) run once on its
    ``meta`` input specs under a ``StepCost``."""
    bundle = make_step(cfg, None, shape)
    with StepCost(bundle.input_specs) as cost:
        out = bundle.fn(**bundle.input_specs)
    cost.output_bytes = cost.live - cost.input_bytes
    del out
    return cost


def account(arch: str, cfg: ModelConfig, shape: ShapeConfig, strategy: str,
            verbose: bool = True) -> Dict[str, Any]:
    """The dry-run record of ``cfg`` (arch ``arch``) at ``shape``, any
    ``ShapeConfig`` (a cell's, or one cut to size)."""
    t0 = time.time()
    cost = count_cell(cfg, shape)
    count_s = time.time() - t0
    coll = no_collectives()
    terms = roofline_terms(cost.flops, cost.total_bytes, coll)
    mf = model_flops(cfg, shape)
    mem = {"argument_size_in_bytes": cost.input_bytes,
           "output_size_in_bytes": cost.output_bytes,
           "peak_bytes_per_device": cost.peak}
    record = {
        "arch": arch, "shape": shape.name, "mesh": "1", "strategy": strategy,
        "kind": shape.kind, "n_chips": 1, "count_s": round(count_s, 2),
        "accounting": {"mode": "direct", "note": "eager count on meta: every layer seen"},
        "flops_per_dev": cost.flops,
        "bytes_per_dev": cost.total_bytes,
        "scanned_flops_per_dev": cost.flops,
        "kernel_calls": cost.kernel_calls,
        "kernel_flops": cost.kernel_flops,
        "kernel_bytes": cost.kernel_bytes,
        "collectives": coll,
        "collectives_scanned": no_collectives(),
        "collectives_note": "one device: no collective until Queue 1 item 5a-iv",
        "memory": mem,
        "roofline": terms,
        "model_flops_global": mf,
        "model_flops_per_dev": mf,
        "useful_flops_ratio": mf / cost.flops if cost.flops else None,
        "hbm_fit": cost.peak <= HW["hbm_bytes"],
        "n_params": cfg.n_params(),
        "n_active_params": cfg.n_active_params(),
        "global_batch": shape.global_batch, "seq_len": shape.seq_len,
    }
    if verbose:
        print(f"[dryrun] {arch:24s} {shape.name:12s} B={shape.global_batch:<4d} {strategy:8s} "
              f"count={count_s:6.1f}s flops={cost.flops:.3e} bytes={cost.total_bytes:.3e} "
              f"peakmem={cost.peak / 2**30:.2f}GiB dominant={terms['dominant']} "
              f"bound={terms['bound_s'] * 1e3:.2f}ms "
              f"useful={record['useful_flops_ratio'] or 0:.2f}", flush=True)
    return record


def run_cell(arch: str, shape_name: str, *, strategy: Optional[str] = None,
             overrides: Optional[Dict] = None, verbose: bool = True) -> Dict[str, Any]:
    """The record of the cell (arch, shape_name) of ``configs.base.cells``,
    with the config's ``overrides``."""
    cfg = get_config(arch, **dict(overrides or {}))
    return account(arch, cfg, SHAPES[shape_name],
                   strategy or default_strategy(arch, shape_name), verbose=verbose)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--arch", choices=ARCH_IDS)
    p.add_argument("--shape", choices=list(SHAPES))
    p.add_argument("--all", action="store_true", help="every runnable cell")
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
    os.makedirs(args.out, exist_ok=True)
    failures = []
    for arch, shape_name in todo:
        path = os.path.join(args.out, f"{arch}__{shape_name}.json")
        if args.skip_existing and os.path.exists(path):
            print(f"[dryrun] skip existing {path}")
            continue
        try:
            rec = run_cell(arch, shape_name, overrides=perf_map.get((arch, shape_name)))
        except Exception as e:  # noqa: BLE001  (every cell is tried; failures are listed)
            traceback.print_exc()
            failures.append((arch, shape_name, f"{type(e).__name__}: {e}"))
            continue
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
