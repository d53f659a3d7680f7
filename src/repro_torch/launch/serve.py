"""Serving launcher: batched requests through the continuous-batching engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \
      --requests 12 --max-batch 4 --max-new 8               # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b --full-width \
      --requests 16 --max-batch 8 --prefill-len 512 --max-len 1024 --max-new 32
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --json
  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b --device cpu --json
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-moe-3b-a800m --device cpu --json
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-125m --device cpu --json

Port of ``repro.launch.serve`` with four more flags: ``--device`` (default
``cuda``; without a card it raises unless ``--device cpu``), ``--full-width``
(the arch's published config instead of its smoke config),
``--attention-impl`` (``pallas`` routes prefill and decode attention through
the CUDA kernels; ``xla`` is plain PyTorch) and, for the hybrid family,
``--scan-impl`` (the prefill scan: ``assoc`` through K4, ``chunked`` or
``chunked_u`` through K3).  Hybrid and xlstm prompts are exactly
``--prefill-len`` tokens, as the engine requires for recurrent families; the
xlstm family reaches no kernel on either ``--attention-impl``.  The vlm and encdec
families are refused with the engine's reason (``UNSERVED_FAMILIES``); they
decode through ``repro_torch.models.decoding``.

Reports throughput (tokens/sec, requests/sec) and per-request latency
percentiles (submit -> finish, so queueing inside the engine counts).
``--json`` prints the summary as one JSON object; ``main`` also returns it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models.ssm import SCAN_IMPLS
from repro_torch.models.transformer import PORTED_FAMILIES
from repro_torch.serving import ServingEngine
from repro_torch.serving.engine import UNSERVED_FAMILIES
from repro_torch.steps import init_model, resolve_device


def _pct(sorted_vals, p):
    if not sorted_vals:
        return None
    return sorted_vals[min(len(sorted_vals) - 1, int(len(sorted_vals) * p))]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="gemma-2b", choices=ARCH_IDS)
    p.add_argument("--requests", type=int, default=12)
    p.add_argument("--max-batch", type=int, default=4)
    p.add_argument("--max-new", type=int, default=8)
    p.add_argument("--prefill-len", type=int, default=16)
    p.add_argument("--max-len", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--full-width", action="store_true",
                   help="the arch's full config instead of its smoke config")
    p.add_argument("--attention-impl", default="pallas", choices=("pallas", "xla"),
                   help="pallas: the CUDA attention kernels; xla: plain PyTorch")
    p.add_argument("--scan-impl", default=None, choices=SCAN_IMPLS,
                   help="hybrid family: the prefill scan (default: the config's)")
    p.add_argument("--json", action="store_true",
                   help="emit the summary as one JSON object")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    make = get_config if args.full_width else get_smoke_config
    cfg = make(args.arch, attention_impl=args.attention_impl)
    if cfg.family not in PORTED_FAMILIES:
        raise SystemExit(f"serve in repro_torch runs the {PORTED_FAMILIES} families; "
                         f"{args.arch} is {cfg.family!r}, not ported yet")
    if cfg.family in UNSERVED_FAMILIES:
        raise SystemExit(f"serve: {UNSERVED_FAMILIES[cfg.family]} ({args.arch} is "
                         f"{cfg.family!r}); it decodes through repro_torch.models.decoding")
    if args.scan_impl is not None:
        if cfg.ssm is None:
            raise SystemExit(f"--scan-impl: {args.arch} has no SSM mixer")
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, scan_impl=args.scan_impl))
    _, params = init_model(cfg, seed=args.seed, max_seq=args.max_len, device=device)
    eng = ServingEngine(cfg, params, max_batch=args.max_batch, max_len=args.max_len,
                        prefill_len=args.prefill_len, device=device)
    rng = np.random.RandomState(args.seed)
    _sync(device)
    t0 = time.time()
    submit_t = {}
    ids = []
    for _ in range(args.requests):
        rid = eng.submit([int(t) for t in rng.randint(1, cfg.vocab, size=args.prefill_len)],
                         max_new_tokens=args.max_new)
        submit_t[rid] = time.time()
        ids.append(rid)
    # pump the engine by hand (instead of run_until_idle) so each request's
    # finish time, and with it the latency distribution, is observable; each
    # tick ends in a device->host copy of the sampled tokens, so the clock
    # reads finished work
    finish_t = {}
    pending = set(ids)
    for _ in range(100_000):
        if not pending:
            break
        eng.step()
        now = time.time()
        for rid in list(pending):
            if rid in eng.finished:
                finish_t[rid] = now
                pending.discard(rid)
    _sync(device)
    dt = time.time() - t0
    results = {rid: r.generated for rid, r in eng.finished.items()}

    lat = sorted(finish_t[rid] - submit_t[rid] for rid in ids if rid in finish_t)
    toks = eng.stats["tokens"]
    summary = {
        "arch": args.arch, "full_width": args.full_width, "device": str(device),
        "attention_impl": args.attention_impl,
        "scan_impl": cfg.ssm.scan_impl if cfg.ssm is not None else None, "dtype": cfg.dtype,
        "requests": args.requests, "completed": len(finish_t), "tokens": toks,
        "wall_s": round(dt, 4),
        "tokens_per_s": round(toks / dt, 2) if dt > 0 else None,
        "requests_per_s": round(len(finish_t) / dt, 2) if dt > 0 else None,
        "latency_p50_s": _pct(lat, 0.50),
        "latency_p90_s": _pct(lat, 0.90),
        "latency_p99_s": _pct(lat, 0.99),
        "decode_ticks": eng.stats["decode_ticks"],
        "prefills": eng.stats["prefills"],
    }
    if args.json:
        print(json.dumps(summary))
        return summary
    for rid in ids[:4]:
        print(f"[serve] req {rid}: {results[rid]}")
    print(f"[serve] {summary['completed']}/{args.requests} requests, "
          f"{toks} tokens in {dt:.2f}s ({summary['tokens_per_s']} tok/s, "
          f"{summary['requests_per_s']} req/s)")
    print(f"[serve] latency p50={summary['latency_p50_s']:.4f}s "
          f"p90={summary['latency_p90_s']:.4f}s "
          f"p99={summary['latency_p99_s']:.4f}s "
          f"({summary['decode_ticks']} ticks, "
          f"{summary['prefills']} prefills)")
    return summary


if __name__ == "__main__":
    main()
