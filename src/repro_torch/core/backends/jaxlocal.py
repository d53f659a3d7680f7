"""jaxlocal: the resource manager whose jobs are real model runs, in PyTorch.

The port's twin of ``repro.core.backends.jaxlocal``.  It keeps the reference's
name, image (``jaxpod:0.1``) and REST dialect (slurmrestd), so the Bridge's
``JaxLocalAdapter`` drives it unchanged; its jobs are PyTorch runs of the
port's models on the card (``device="cuda"``, the default) or, when the
caller asks for it, on the CPU.

Job script = JSON, with the reference's keys and defaults::

    {"arch": "gemma-2b", "steps": 200, "batch": 8, "seq": 64,
     "checkpoint_every": 20, "workdir": "ckpts:runs/demo", "lr": 3e-3,
     "task": "affine", "seed": 0, "crash_at_step": 0, "keep_checkpoints": 3,
     "config_overrides": {}}

    {"mode": "serve", "arch": "gemma-2b", "max_len": 64, "prefill_len": 16,
     "max_batch": 4, "seed": 0, "config_overrides": {}}

The config is ``get_smoke_config(arch, **config_overrides)``: a full-width
model is asked for by overriding the smoke config's fields.
``crash_at_step`` > 0 makes a train job fail at that step once it has made
progress (fault injection): a resubmitted job with the same workdir resumes
from the last checkpoint rather than step 0.

The Bridge's adapter (``JaxLocalAdapter``) stays in ``repro.core``.
"""
from __future__ import annotations

import json
import threading
from typing import Any, Dict, Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ShapeConfig, get_smoke_config
from repro_torch.core.backends import base as B
from repro_torch.core.backends.slurm import make_server as make_slurm_server
from repro_torch.core.objectstore import ObjectStore
from repro_torch.core.rest import RestServer
from repro_torch.data import DataConfig, SyntheticDataset
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.serving.engine import ServingEngine
from repro_torch.steps import init_model, make_train_step, resolve_device


def train_job(spec: Dict[str, Any], store: ObjectStore,
              cancel: Optional[threading.Event] = None,
              log: Optional[list] = None, device="cuda") -> Dict[str, Any]:
    """Run (or resume) one training job, the reference's loop: warmup
    ``min(20, steps // 4 + 1)``, no remat, a checkpoint every
    ``checkpoint_every`` steps and one at ``steps``.  Returns final metrics.

    Importable directly (examples/tests) or via the cluster payload below.
    """
    dev = resolve_device(device)
    arch = spec.get("arch", "gemma-2b")
    steps = int(spec.get("steps", 50))
    batch_sz = int(spec.get("batch", 4))
    seq = int(spec.get("seq", 32))
    ckpt_every = int(spec.get("checkpoint_every", 0))
    lr = float(spec.get("lr", 1e-3))
    crash_at = int(spec.get("crash_at_step", 0))
    overrides = dict(spec.get("config_overrides", {}))

    cfg = get_smoke_config(arch, **overrides)
    ds = SyntheticDataset(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                     global_batch=batch_sz,
                                     task=spec.get("task", "affine"),
                                     seed=int(spec.get("seed", 0))))
    opt_cfg = AdamWConfig(lr=lr, warmup_steps=min(20, steps // 4 + 1),
                          total_steps=steps)

    _, params = init_model(cfg, seed=int(spec.get("seed", 0)), max_seq=seq,
                           device=dev)
    opt_state = adamw_init(params)

    mgr = None
    start_step = 0
    if ckpt_every and spec.get("workdir"):
        bucket, prefix = ObjectStore.parse_ref(spec["workdir"])
        mgr = CheckpointManager(store, bucket, prefix,
                                keep=int(spec.get("keep_checkpoints", 3)))
        resumed = mgr.restore_latest({"params": params, "opt": opt_state})
        if resumed is not None:
            start_step, tree, _extra = resumed
            params, opt_state = tree["params"], tree["opt"]

    step_fn = make_train_step(cfg, None, ShapeConfig("job", seq, batch_sz, "train"),
                              opt_cfg, remat=False).fn

    history = []
    for step in range(start_step, steps):
        if cancel is not None and cancel.is_set():
            if mgr:
                mgr.wait()
            return {"state": "cancelled", "step": step, "history": history}
        if crash_at and step == crash_at and step > start_step:
            # simulated node failure mid-run (AFTER making some progress)
            raise RuntimeError(f"injected crash at step {step}")
        batch = {k: torch.from_numpy(v).to(dev) for k, v in ds.batch(step).items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        history.append(loss)
        if log is not None:
            log.append((step, loss))
        if mgr and ckpt_every and (step + 1) % ckpt_every == 0:
            mgr.save_async(step + 1, {"params": params, "opt": opt_state},
                           extra={"loss": loss})
    if mgr:
        mgr.wait()
        mgr.save(steps, {"params": params, "opt": opt_state},
                 extra={"loss": history[-1] if history else None})
    return {"state": "done", "step": steps, "history": history,
            "final_loss": history[-1] if history else None,
            "start_step": start_step}


def serve_job(spec: Dict[str, Any], job: B.ClusterJob,
              cluster: B.SimulatedCluster, device="cuda") -> int:
    """Serve-mode replica: host the port's ``ServingEngine`` behind the
    cluster's ``POST /.../invoke`` route until cancelled.

    The payload thread is the engine pump (continuous batching over the
    shared KV cache); REST worker threads call ``job.handler``, which
    enqueues a request and parks on a condition variable until the pump
    moves it to ``finished``.  A replica killed mid-request raises out of
    the handler (HTTP 500), which the service router treats as a replica
    fault and retries elsewhere.  Serve jobs never auto-complete: only a
    cancel ends them.  An engine tick that raises (a kernel that fails on
    the card) fails the job with its reason, and every parked request raises
    with it; the reference's parked requests would wait on, since no cancel
    is set (ROADMAP.md, R4).
    """
    dev = resolve_device(device)
    arch = spec.get("arch", "gemma-2b")
    max_len = int(spec.get("max_len", 64))
    prefill_len = int(spec.get("prefill_len", 16))
    cfg = get_smoke_config(arch, **dict(spec.get("config_overrides", {})))
    _, params = init_model(cfg, seed=int(spec.get("seed", 0)),
                           max_seq=max_len, device=dev)
    eng = ServingEngine(cfg, params,
                        max_batch=int(spec.get("max_batch", 4)),
                        max_len=max_len, prefill_len=prefill_len, device=dev)
    cond = threading.Condition()
    results: Dict[int, Any] = {}
    pump_error: list = []

    def handler(body: Any) -> Dict[str, Any]:
        body = body or {}
        prompt = [int(t) for t in body.get("prompt", [])]
        with cond:
            if job._cancel.is_set() or pump_error:
                raise RuntimeError("replica shutting down")
            rid = eng.submit(prompt,
                             max_new_tokens=int(body.get("max_new_tokens", 8)),
                             eos_id=body.get("eos_id"))
            cond.notify_all()
            while rid not in results:
                if job._cancel.is_set():
                    raise RuntimeError("replica cancelled mid-request")
                if pump_error:
                    raise RuntimeError(f"replica failed mid-request: {pump_error[0]}")
                cond.wait(timeout=0.05)
            req = results.pop(rid)
        return {"tokens": req.generated, "served_by": job.id, "arch": arch}

    job.handler = handler
    try:
        while not job._cancel.is_set():
            with cond:
                busy = (bool(eng.pending)
                        or any(s is not None for s in eng.slots))
                if not busy:
                    cond.wait(timeout=0.02)
                    continue
                eng.step()
                if eng.finished:
                    results.update(eng.finished)
                    eng.finished.clear()
                    cond.notify_all()
        return -1
    except Exception as e:
        pump_error.append(f"{type(e).__name__}: {e}")
        raise
    finally:
        job.handler = None
        with cond:
            cond.notify_all()  # release parked handlers to see the cancel


def jax_train_payload(store: ObjectStore, device="cuda") -> B.Payload:
    """The cluster's payload: a train job, or a serve job (``mode: serve``).
    ``device`` is resolved here, once, so a missing card raises when the
    cluster is built rather than failing each job on its worker thread."""
    dev = resolve_device(device)

    def run(job: B.ClusterJob, cluster: B.SimulatedCluster) -> int:
        spec = json.loads(job.script)
        if spec.get("mode") == "serve":
            return serve_job(spec, job, cluster, device=dev)
        result = train_job(spec, store, cancel=job._cancel, device=dev)
        job.outputs[job.properties.get("OutputFileName", "train.out")] = (
            json.dumps({k: v for k, v in result.items() if k != "history"})
            .encode())
        if result["state"] == "cancelled":
            return -1
        # publish the loss curve to S3 (output upload per paper §4)
        if spec.get("workdir"):
            bucket, prefix = ObjectStore.parse_ref(spec["workdir"])
            store.put(bucket, f"{prefix}/history_{job.id}.json",
                      json.dumps(result["history"]).encode())
        return 0

    return run


def make_jaxlocal_cluster(store: ObjectStore, name: str = "jaxlocal",
                          slots: int = 2, start_numbering: int = 7000,
                          device="cuda") -> B.SimulatedCluster:
    # start_numbering is per-cluster so a second jaxlocal resource (serving
    # across managers) hands out non-overlapping job ids
    return B.SimulatedCluster(name=name, slots=slots,
                              payload=jax_train_payload(store, device=device),
                              start_numbering=start_numbering)


def make_server(cluster: B.SimulatedCluster, token: str = "") -> RestServer:
    return make_slurm_server(cluster, token=token)
