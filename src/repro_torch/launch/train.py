"""Training launcher: AdamW steps on synthetic batches, with checkpoint
resume.

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

Port of ``repro.launch.train`` with two more flags: ``--device`` (default
``cuda``; without a card it raises unless ``--device cpu``) and ``--json``
(print the result as one JSON object after ``[train] done``).  Without
``--smoke`` it trains the arch's full config.  The reference's ``--data``,
``--model``, ``--strategy`` and ``--no-zero1`` wait for distribution.  A
rerun with the same ``--ckpt-dir`` resumes from its latest checkpoint.

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
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ARCH_IDS, ModelConfig, get_config, get_smoke_config
from repro_torch.core.objectstore import ObjectStore
from repro_torch.data import DataConfig, SyntheticDataset, with_frontend_stubs
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.steps import init_model, make_train_step, resolve_device


def train(cfg: ModelConfig, steps: int, batch: int, seq: int, lr: float = 1e-2,
          seed: int = 0, remat: bool = True, mgr: Optional[CheckpointManager] = None,
          ckpt_every: int = 0, crash_at_step: int = 0,
          cancel: Optional[threading.Event] = None, log_every: int = 0,
          on_step: Optional[Callable[[int, Any, Dict[str, float]], None]] = None,
          device="cuda") -> Dict[str, Any]:
    """Run (or, from ``mgr``'s latest checkpoint, resume) ``steps`` AdamW
    steps on the affine synthetic task: peak ``lr`` after a warmup of
    ``max(steps // 10, 1)`` steps, then a cosine decay to ``steps``.

    ``crash_at_step`` > 0 raises ``RuntimeError`` at that step once the run
    has made progress (fault injection; an in-flight save is let finish
    first, so the resume point is deterministic).  ``cancel`` is checked
    before each step.  ``mgr`` saves asynchronously every ``ckpt_every``
    steps and once at the end.  ``on_step(step, params, metrics)`` is called
    after each step with the metrics as floats.  Returns {"state", "step",
    "history" (losses), "final_loss", "start_step"}."""
    dev = resolve_device(device)
    opt_cfg = AdamWConfig(lr=lr, warmup_steps=max(steps // 10, 1), total_steps=steps)
    ds = SyntheticDataset(DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                                     seed=seed))
    _, params = init_model(cfg, seed=seed, max_seq=seq, device=dev)
    opt_state = adamw_init(params)
    start = 0
    if mgr is not None:
        resumed = mgr.restore_latest({"params": params, "opt": opt_state})
        if resumed is not None:
            start, tree, _extra = resumed
            params, opt_state = tree["params"], tree["opt"]
            print(f"[train] resumed from step {start}", flush=True)

    step_fn = make_train_step(cfg, opt_cfg, remat=remat)
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
        params, opt_state, metrics = step_fn(params, opt_state, b)
        m = {k: float(v) for k, v in metrics.items()}
        history.append(m["loss"])
        if on_step is not None:
            on_step(step, params, m)
        if log_every and ((step + 1) % log_every == 0 or step == start):
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


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="gemma-2b", choices=ARCH_IDS)
    p.add_argument("--smoke", action="store_true", help="reduced config")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--seq", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-2)
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
    mgr = None
    if args.ckpt_dir and args.ckpt_every:
        mgr = CheckpointManager(ObjectStore(root=args.ckpt_dir), "ckpt", "run")
    result = train(cfg, args.steps, args.batch, args.seq, lr=args.lr, seed=args.seed,
                   remat=not args.no_remat, mgr=mgr, ckpt_every=args.ckpt_every,
                   log_every=args.log_every, device=device)
    if mgr is not None:
        print(f"[train] checkpointed at {args.ckpt_dir}")
    print("[train] done")
    if args.json:
        print(json.dumps(dict(result, arch=args.arch, smoke=args.smoke, device=str(device))))
    return result


if __name__ == "__main__":
    main()
