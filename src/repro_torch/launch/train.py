"""Training launcher: AdamW steps on synthetic batches, with checkpoint
resume, on one device or on a (data, model) mesh.

  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --steps 50 --batch 4 --seq 64 --ckpt-dir /tmp/run1 --ckpt-every 10
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \\
      --steps 4 --batch 4 --seq 512 --no-remat          # full width, on the card
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-moe-3b-a800m \\
      --smoke --device cpu --steps 2
  PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-large-v3 \\
      --smoke --device cpu --steps 2      # also phi-3-vision-4.2b
  PYTHONPATH=src python -m repro_torch.launch.train --arch hymba-1.5b \\
      --smoke --device cpu --steps 2      # also xlstm-125m
  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \\
      --smoke --device cpu --data 2 --model 2 --strategy fsdp_tp --steps 4
                                          # a (2, 2) mesh of 4 gloo ranks

Port of ``repro.launch.train`` with two more flags: ``--device`` (default
``cuda``; without a card it raises unless ``--device cpu``) and ``--json``
(print the result as one JSON object after ``[train] done``).  Without
``--smoke`` it trains the arch's full config.  ``--data`` and ``--model``
(default 1) size the mesh, ``--strategy`` picks the sharding rules (``tp``
or ``fsdp_tp``) and ``--no-zero1`` keeps the moments placed as their
params.  At 1 x 1 there is no mesh (``mesh=None``, one device); past it the
ranks are torchrun's (``torchrun --nproc-per-node <data x model>``): the
launcher starts a process group from its environment (NCCL on the cards,
gloo with ``--device cpu``) and raises without it.  On a mesh all six
families train (dense, vlm, hybrid, moe, encdec and ssm); rank 0 prints
and writes the checkpoints.  A rerun with the same
``--ckpt-dir`` resumes from its latest checkpoint, on any mesh.

``train`` holds the loop of the reference's ``jaxlocal.train_job`` and is
what the CLI, the tests and ``chip_smoke.py`` call.  Every batch carries
the stub frontend's embeddings (``with_frontend_stubs``; vlm and encdec
only), as in the reference CLI.  Every family trains with
``attention_impl="xla"`` (the moe loss adds 0.01 x the load-balance aux);
the hybrid block's Mamba mixer trains through the reference's
differentiable scans (``--scan-impl`` is a serve flag: the config's
``scan_impl`` picks ``assoc`` or ``chunked``), and the xlstm blocks have no
kernel.  ``"pallas"`` attention reaches K1, which has no backward: its
wrapper raises in step 0's forward, before any param changes (see
``kernels/ops.py``).
"""
from __future__ import annotations

import argparse
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch import sharding as SH
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import (ARCH_IDS, ModelConfig, ShapeConfig, get_config,
                                      get_smoke_config)
from repro_torch.core.objectstore import ObjectStore
from repro_torch.data import DataConfig, SyntheticDataset, with_frontend_stubs
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.steps import init_model, make_train_step, resolve_device


def train(cfg: ModelConfig, steps: int, batch: int, seq: int, lr: float = 1e-2,
          seed: int = 0, remat: bool = True, mgr: Optional[CheckpointManager] = None,
          ckpt_every: int = 0, crash_at_step: int = 0,
          cancel: Optional[threading.Event] = None, log_every: int = 0,
          on_step: Optional[Callable[[int, Any, Dict[str, float]], None]] = None,
          device="cuda", mesh=None, strategy: str = "tp", zero1: bool = True
          ) -> Dict[str, Any]:
    """Run (or, from ``mgr``'s latest checkpoint, resume) ``steps`` AdamW
    steps on the affine synthetic task: peak ``lr`` after a warmup of
    ``max(steps // 10, 1)`` steps, then a cosine decay to ``steps``.

    ``crash_at_step`` > 0 raises ``RuntimeError`` at that step once the run
    has made progress (fault injection; an in-flight save is let finish
    first, so the resume point is deterministic).  ``cancel`` is checked
    before each step.  ``mgr`` saves asynchronously every ``ckpt_every``
    steps and once at the end.  ``on_step(step, params, metrics)`` is called
    after each step with the metrics as floats.  With a ``mesh`` (a
    ``DeviceMesh``, every rank calling) the params, the optimizer state and
    each batch are placed by the train bundle's ``in_shardings`` (``strategy``,
    ``zero1``), and a resume restores onto them, whatever mesh saved.
    Returns {"state", "step", "history" (losses), "final_loss",
    "start_step"}."""
    dev = resolve_device(device)
    lead = mesh is None or torch.distributed.get_rank() == 0
    opt_cfg = AdamWConfig(lr=lr, warmup_steps=max(steps // 10, 1), total_steps=steps)
    ds = SyntheticDataset(DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                                     seed=seed))
    bundle = make_train_step(cfg, mesh, ShapeConfig("train", seq, batch, "train"), opt_cfg,
                             strategy, zero1, remat)
    _, params = init_model(cfg, seed=seed, max_seq=seq, device=dev)
    shardings = None
    if mesh is not None:
        p_specs, o_specs, b_specs = bundle.in_shardings
        params = SH.distribute(params, mesh, p_specs)
        shardings = {"params": p_specs, "opt": o_specs}
        opt_state = adamw_init(params, o_specs)
    else:
        opt_state = adamw_init(params)
    start = 0
    if mgr is not None:
        resumed = mgr.restore_latest({"params": params, "opt": opt_state},
                                     shardings=shardings, mesh=mesh)
        if resumed is not None:
            start, tree, _extra = resumed
            params, opt_state = tree["params"], tree["opt"]
            if lead:
                print(f"[train] resumed from step {start}", flush=True)

    history: List[float] = []
    t0 = time.perf_counter()
    for step in range(start, steps):
        if cancel is not None and cancel.is_set():
            if mgr is not None:
                mgr.wait()
            return {"state": "cancelled", "step": step, "history": history}
        if crash_at_step and step == crash_at_step and step > start:
            if mgr is not None:
                mgr.wait()
            raise RuntimeError(f"injected crash at step {step}")
        b = {k: torch.from_numpy(v).to(dev)
             for k, v in with_frontend_stubs(ds.batch(step), cfg, seed=seed).items()}
        if mesh is not None:
            b = SH.distribute(b, mesh, b_specs)
        params, opt_state, metrics = bundle.fn(params, opt_state, b)
        m = {k: float(v) for k, v in metrics.items()}
        history.append(m["loss"])
        if on_step is not None:
            on_step(step, params, m)
        if lead and log_every and ((step + 1) % log_every == 0 or step == start):
            dt = (time.perf_counter() - t0) / (step - start + 1)
            print(f"[train] step {step + 1:5d} loss={m['loss']:.4f} "
                  f"gnorm={m['grad_norm']:.3f} lr={m['lr']:.2e} {dt * 1e3:.0f} ms/step",
                  flush=True)
        if mgr is not None and ckpt_every and (step + 1) % ckpt_every == 0:
            mgr.save_async(step + 1, {"params": params, "opt": opt_state},
                           extra={"loss": m["loss"]})
    if mgr is not None:
        mgr.wait()
        mgr.save(steps, {"params": params, "opt": opt_state},
                 extra={"loss": history[-1] if history else None})
    return {"state": "done", "step": steps, "history": history,
            "final_loss": history[-1] if history else None, "start_step": start}


TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def start_mesh(data: int, model: int, device: torch.device):
    """The (data, model) mesh over the ranks torchrun started: a process
    group from its environment (``init_method="env://"``; NCCL for ``cuda``,
    each rank on its ``LOCAL_RANK``'s card, gloo for the CPU).  Raises,
    naming torchrun, when that environment is missing or its world size is
    not ``data * model``."""
    import torch.distributed as dist

    n = data * model
    missing = [k for k in TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"--data {data} --model {model} runs on {n} ranks: start them with "
                           f"torchrun --nproc-per-node {n} (the environment has no "
                           f"{', '.join(missing)})")
    if int(os.environ["WORLD_SIZE"]) != n:
        raise RuntimeError(f"--data {data} --model {model} needs {n} ranks, torchrun started "
                           f"{os.environ['WORLD_SIZE']}: run torchrun --nproc-per-node {n}")
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", init_method="env://")
    return make_local_mesh(data, model, device=device.type)


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="gemma-2b", choices=ARCH_IDS)
    p.add_argument("--smoke", action="store_true", help="reduced config")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--seq", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--data", type=int, default=1, help="data mesh dim")
    p.add_argument("--model", type=int, default=1, help="model mesh dim")
    p.add_argument("--strategy", default="tp", choices=["tp", "fsdp_tp"])
    p.add_argument("--no-zero1", action="store_true")
    p.add_argument("--no-remat", action="store_true")
    p.add_argument("--ckpt-dir", default="")
    p.add_argument("--ckpt-every", type=int, default=0)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--json", action="store_true",
                   help="print the result as one JSON object")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    mesh = start_mesh(args.data, args.model, device) if args.data * args.model > 1 else None
    try:
        mgr = None
        if args.ckpt_dir and args.ckpt_every:
            mgr = CheckpointManager(ObjectStore(root=args.ckpt_dir), "ckpt", "run")
        result = train(cfg, args.steps, args.batch, args.seq, lr=args.lr, seed=args.seed,
                       remat=not args.no_remat, mgr=mgr, ckpt_every=args.ckpt_every,
                       log_every=args.log_every, device=device, mesh=mesh,
                       strategy=args.strategy, zero1=not args.no_zero1)
    finally:
        if mesh is not None:
            torch.distributed.destroy_process_group()
    if mesh is None or int(os.environ["RANK"]) == 0:
        if mgr is not None:
            print(f"[train] checkpointed at {args.ckpt_dir}")
        print("[train] done")
        if args.json:
            print(json.dumps(dict(result, arch=args.arch, smoke=args.smoke, device=str(device),
                                  data=args.data, model=args.model, strategy=args.strategy,
                                  zero1=not args.no_zero1)))
    return result


if __name__ == "__main__":
    main()
