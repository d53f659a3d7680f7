#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (``src/repro_torch``).

    python3 chip_smoke.py        # needs one CUDA card (sm_90) and nvcc

Phases, in order; any failure exits non-zero with its traceback:

1. device  - require CUDA and an sm_90 card; print versions and
             ``nvidia-smi --query-gpu=name,power.limit``.
2. build   - compile the kernels in ``src/repro_torch/kernels/csrc`` with nvcc
             for sm_90a (one process per source, in parallel).
3. kernels - each CUDA kernel against its plain PyTorch version on the card,
             in f32 (tol 2e-5) and bf16 (tol 2e-2), at the model's shapes,
             ragged shapes and a GQA shape; decode also with NaN past lengths.
4. parity  - gemma-2b at full width in f32: prefill + 4 decode steps through
             the kernels (attention_impl="pallas") and through plain PyTorch
             ("xla"): every layer and the logits on the same input, and the
             entry points at a cut depth, relative to max |reference|; at
             full depth the entry points' drift beside a control that
             perturbs the plain route's input at f32 rounding.  The launch
             counters must rise by n_layers per prefill and per decode step.
5. serve   - ``repro_torch.launch.serve.main`` at full width in bf16 (16
             requests, 8 slots, 512-token prompts, 32 new tokens each); every
             request must complete and every prefill/decode must have gone
             through the kernels.
6. timing  - each kernel at the serve shapes: its device time (profiler) and
             time per call (CUDA events, host launch cost included), the
             same for its plain version and for scaled_dot_product_attention
             (a yardstick the port never calls), and the roofline bound; then
             a profile of one decode tick.

The last three lines are the card's name and power limit, one JSON object
with the per-kernel numbers, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM published peaks (NVIDIA data sheet), for the roofline bound
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # tests/test_kernels.py::_tol
PARITY_REL_TOL = 1e-5  # full-width f32: max error / max |reference|
# layers of the cut model whose entry points are held to PARITY_REL_TOL: at 2,
# an f32 rounding of the input already grows to half that tolerance
PARITY_DEPTH = 1
CHAOS_FACTOR = 10  # most kernel-route drift per unit of the control's drift

SERVE_ARGS = ["--arch", "gemma-2b", "--full-width", "--attention-impl", "pallas",
              "--device", "cuda", "--requests", "16", "--max-batch", "8",
              "--prefill-len", "512", "--max-len", "1024", "--max-new", "32", "--json"]


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def check_close(what: str, got, want, dtype_name: str) -> float:
    import torch

    tol = TOL[dtype_name]
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: got {tuple(got.shape)} {got.dtype}, "
                             f"want {tuple(want.shape)} {want.dtype}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite output")
    bad = (got.float() - want.float()).abs() > tol + tol * want.float().abs()
    err = max_err(got, want)
    if bool(bad.any()):
        raise AssertionError(f"{what}: max_abs_err {err:.3e} beyond atol = rtol = {tol}")
    return err


def call_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean time per call of fn() from CUDA events around ``iters`` back-to-back
    calls: the host's launch cost is included where it exceeds the device's."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20, warmup: int = 5) -> float:
    """Mean device time per call of fn(): the profiler's sum of the device
    time of every kernel and copy the calls launched, over ``iters``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type.name == "CUDA")
    if busy_us <= 0:
        raise RuntimeError("the profiler saw no device time")
    return busy_us / iters / 1e3


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("[device] CUDA is not available: this smoke test runs on the card")
    if not (SRC / "repro_torch").is_dir():
        raise SystemExit(f"[device] {SRC / 'repro_torch'} is missing: run from a checkout")
    sys.path.insert(0, str(SRC))
    cap = torch.cuda.get_device_capability(0)
    log("device", f"{torch.cuda.get_device_name(0)} sm_{cap[0]}{cap[1]}, "
        f"count {torch.cuda.device_count()}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, python {sys.version.split()[0]}")
    if cap != (9, 0):
        raise SystemExit(f"[device] the kernels are built for sm_90a; this card is sm_{cap[0]}{cap[1]}")
    smi = nvidia_smi()
    log("device", f"nvidia-smi: {smi}")
    # every f32 comparison below is against full-f32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build() -> None:
    from repro_torch.kernels import _build

    path, build_log, secs = _build.build()
    log("build", f"{len(_build.sources())} sources -> {path.relative_to(ROOT)} in {secs:.1f}s "
        f"({' '.join(_build.NVCC_FLAGS)})")
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log("build", line.strip())
    _build.library()


def _flash_inputs(b, s, hq, hkv, d, dtype, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(b, s, hq, d, generator=g, device="cuda").to(dtype)
    k = torch.randn(b, s, hkv, d, generator=g, device="cuda").to(dtype)
    v = torch.randn(b, s, hkv, d, generator=g, device="cuda").to(dtype)
    return q, k, v


def _decode_inputs(b, m, hq, hkv, d, dtype, seed, lengths):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(b, 1, hq, d, generator=g, device="cuda").to(dtype)
    ck = torch.randn(b, m, hkv, d, generator=g, device="cuda").to(dtype)
    cv = torch.randn(b, m, hkv, d, generator=g, device="cuda").to(dtype)
    return q, ck, cv, torch.tensor(lengths, dtype=torch.int32, device="cuda")


def flash_plain(q, k, v):
    from repro_torch.kernels import ref

    return ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2)).transpose(1, 2)


def decode_plain(q, ck, cv, lengths):
    from repro_torch.kernels import ref

    return ref.decode_attention_ref(q[:, 0], ck.transpose(1, 2), cv.transpose(1, 2),
                                    lengths)[:, None]


def phase_kernels() -> dict:
    """Each kernel against its plain version; returns the worst error per kernel."""
    import torch

    from repro_torch.kernels import ops

    worst = {"flash_attention": 0.0, "decode_attention": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        for shape in [(1, 512, 8, 1, 256), (1, 77, 8, 1, 256), (2, 300, 8, 2, 128)]:
            q, k, v = _flash_inputs(*shape, dtype, seed=sum(shape))
            got = ops.flash_attention(q, k, v)
            torch.cuda.synchronize()
            err = check_close(f"flash_attention {name} {shape}", got, flash_plain(q, k, v), name)
            worst["flash_attention"] = max(worst["flash_attention"], err)
            log("kernels", f"flash_attention {name} B,S,Hq,Hkv,D={shape}: max_abs_err {err:.3e} "
                f"(atol = rtol = {TOL[name]}) ok")
        for shape, lengths in [((8, 1024, 8, 1, 256), [1, 17, 64, 300, 511, 512, 1000, 1024]),
                               ((3, 300, 8, 2, 128), [300, 129, 33])]:
            q, ck, cv, lens = _decode_inputs(*shape, dtype, sum(shape), lengths)
            want = decode_plain(q, ck, cv, lens)
            got = ops.decode_attention(q, ck, cv, lens)
            torch.cuda.synchronize()
            err = check_close(f"decode_attention {name} {shape}", got, want, name)
            # NaN in every slot past lengths must not reach the output
            mask = torch.arange(shape[1], device="cuda")[None, :] >= lens[:, None]
            ck[mask] = float("nan")
            cv[mask] = float("nan")
            poisoned = ops.decode_attention(q, ck, cv, lens)
            torch.cuda.synchronize()
            if not torch.equal(poisoned, got):
                raise AssertionError(f"decode_attention {name} {shape}: NaN past lengths "
                                     f"changed the output (max diff {max_err(poisoned, got)})")
            worst["decode_attention"] = max(worst["decode_attention"], err)
            log("kernels", f"decode_attention {name} B,M,Hq,Hkv,D={shape} lengths={lengths}: "
                f"max_abs_err {err:.3e} (atol = rtol = {TOL[name]}); NaN past lengths "
                "ignored; ok")
    return worst


def _rel(got, want) -> float:
    """max |got - want| / max |want|; raises if got is misshapen or not finite."""
    import torch

    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{tuple(got.shape)} vs {tuple(want.shape)}, or not finite")
    return max_err(got, want) / float(want.abs().max())


def _check_rel(what: str, got, want) -> float:
    """_rel(got, want), which must stay within PARITY_REL_TOL."""
    rel = _rel(got, want)
    if rel > PARITY_REL_TOL:
        raise AssertionError(f"{what}: max_abs_err / max |want| = {rel:.3e} > {PARITY_REL_TOL}")
    return rel


def _nudged(params: dict) -> dict:
    """params with layer 0's pre-attention norm scale moved one f32 step up
    (1 -> 1 + 2**-23): the model's input perturbed at f32 rounding.  Every
    other tensor is shared with ``params``."""
    import torch

    scale = params["blocks"]["ln_attn"]["scale"].clone()
    scale[0] = torch.nextafter(scale[0], torch.full_like(scale[0], float("inf")))
    blocks = {**params["blocks"], "ln_attn": {**params["blocks"]["ln_attn"], "scale": scale}}
    return {**params, "blocks": blocks}


def _entry_points(params: dict, cfg, prompt, steps, max_len: int) -> list:
    """Logits of prefill and of each decode step, through the entry points."""
    from repro_torch.models import decoding as DEC

    out, cache = DEC.prefill(params, cfg, {"tokens": prompt}, max_len=max_len)
    got = [out]
    for tok in steps:
        out, cache = DEC.decode_step(params, cfg, cache, tok)
        got.append(out)
    return got


def phase_parity() -> None:
    """Full-width gemma-2b in f32: kernel route ("pallas") vs plain route ("xla").

    Under the reference's init (fan-in of wq/wk taken from the head dims, so
    q and k entries have std ~16 and ~45) the random full-width model's
    attention scores are in the hundreds, and the model is chaotic in f32:
    a rounding-level change of its input grows layer after layer.  So the
    kernel route is held against the plain route in three ways:

    a. layer by layer on the same input (the plain route's stream and cache),
       through all 18 layers, at prefill and at each of 4 decode steps, down
       to the logits, within PARITY_REL_TOL;
    b. end to end through the entry points prefill/decode_step, with the
       model cut to PARITY_DEPTH layers, within PARITY_REL_TOL;
    c. end to end through the entry points at full depth, beside a control:
       the plain route with its input perturbed at f32 rounding (``_nudged``).
       The kernel route may drift no more than CHAOS_FACTOR times as far as
       the control does.
    Between a and b, each route and the control run on their own streams, and
    the prefill logits after every depth are held to the rule of c, so the
    run shows where the chaos sets in.
    """
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import decoding as DEC
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as TF
    from repro_torch.models.params import count_params, tree_map
    from repro_torch.steps import init_model

    cfg = get_config("gemma-2b", dtype="float32")
    cp = dataclasses.replace(cfg, attention_impl="pallas")
    cx = dataclasses.replace(cfg, attention_impl="xla")
    b, s, max_len, n_dec = 2, 128, 256, 4
    t0 = time.perf_counter()
    defs, params = init_model(cfg, seed=0, max_seq=max_len, device="cuda")
    torch.cuda.synchronize()
    log("parity", f"gemma-2b f32, {count_params(defs) / 1e9:.3f}B params, {cfg.n_layers} layers, "
        f"init {time.perf_counter() - t0:.1f}s; prompt B={b} S={s}, {n_dec} decode steps")
    g = torch.Generator(device="cuda").manual_seed(1)
    prompt = torch.randint(1, cfg.vocab, (b, s), generator=g, device="cuda")
    steps = torch.randint(1, cfg.vocab, (n_dec, b, 1), generator=g, device="cuda")
    n = cfg.n_layers
    nudged = _nudged(params)
    routes = {"kernel": (cp, params), "plain": (cx, params), "control": (cx, nudged)}

    def logits_of(x):
        return L.unembed(params["embed"], L.apply_norm(params["ln_f"], x[:, -1:], cfg.norm), cfg)

    def drift(got, want):
        return max(_rel(o, w) for o, w in zip(got, want))

    def run_entry_points(name, c, prm, depth):
        ops.reset_launches()
        got = _entry_points(prm, c, prompt, steps, max_len)
        want = {"flash_attention": depth, "decode_attention": depth * n_dec}
        if name == "kernel" and ops.launches() != want:
            raise AssertionError(f"kernel route launches {ops.launches()}, want {depth} "
                                 f"per prefill and {depth} per decode step")
        return got

    with torch.no_grad():
        # a. layer by layer on the same input, prefill then decode
        x, pos, _ = TF._embed_inputs(params, cfg, {"tokens": prompt})
        embed_rms = float(x.square().mean().sqrt())
        cache = DEC.init_cache(cfg, b, max_len, device="cuda")
        worst = 0.0
        for li in range(n):
            p = TF.layer_params(params["blocks"], li)
            xk, _ = TF._apply_block(p, x, pos, cp)
            x, (k, v) = TF._apply_block(p, x, pos, cx)
            worst = max(worst, _check_rel(f"prefill layer {li}", xk, x))
            cache["k"][li, :, :s], cache["v"][li, :, :s] = k, v
            if li == 0:
                layer0_rms = float(x.square().mean().sqrt())
        rel = _check_rel("prefill logits", logits_of(xk), logits_of(x))
        log("parity", f"a. prefill, same input: worst layer output err / max |x| {worst:.3e}; "
            f"logits err / max |logit| {rel:.3e} (tol {PARITY_REL_TOL}) ok; rms of the "
            f"embedded input {embed_rms:.2f}, of the stream after layer 0 {layer0_rms:.2f}")
        cache["pos"].fill_(s)
        for i in range(n_dec):
            x = L.embed_tokens(params["embed"], steps[i], cfg)
            pos = cache["pos"]
            worst = 0.0
            for li in range(n):
                p = TF.layer_params(params["blocks"], li)
                # both write the same new K/V (computed before attention) into the slot
                xk = DEC._decode_block(p, x, cache["k"][li], cache["v"][li], pos, cp)
                x = DEC._decode_block(p, x, cache["k"][li], cache["v"][li], pos, cx)
                worst = max(worst, _check_rel(f"decode {i + 1} layer {li}", xk, x))
            rel = _check_rel(f"decode {i + 1} logits", logits_of(xk), logits_of(x))
            log("parity", f"a. decode {i + 1}, same input: worst layer output err / max |x| "
                f"{worst:.3e}; logits err / max |logit| {rel:.3e} (tol {PARITY_REL_TOL}) ok")
            cache["pos"] += 1
        del cache

        # each route on its own stream; the prefill logits after every depth
        x0, pos, _ = TF._embed_inputs(params, cfg, {"tokens": prompt})
        xs = dict.fromkeys(routes, x0)
        curve = []
        for li in range(n):
            for name, (c, prm) in routes.items():
                xs[name], _ = TF._apply_block(TF.layer_params(prm["blocks"], li), xs[name], pos, c)
            want = logits_of(xs["plain"])
            dk, dc = (_rel(logits_of(xs["kernel"]), want),
                      _rel(logits_of(xs["control"]), want))
            if dk > max(CHAOS_FACTOR * dc, PARITY_REL_TOL):
                raise AssertionError(f"prefill at depth {li + 1}: the kernel route drifts "
                                     f"{dk:.3e}, more than {CHAOS_FACTOR} x the control's {dc:.3e}")
            curve.append((dk, dc))
        log("parity", "prefill logits drift from the plain route by depth, kernel route / "
            "control: " + ", ".join(f"{i + 1}: {dk:.1e}/{dc:.1e}"
                                    for i, (dk, dc) in enumerate(curve))
            + f"; within {CHAOS_FACTOR} x the control at every depth, ok")
        del xs

        # b. the entry points with the model cut to PARITY_DEPTH layers
        m = PARITY_DEPTH
        cut = {**params, "blocks": tree_map(lambda t: t[:m], params["blocks"])}
        got = {name: run_entry_points(name, dataclasses.replace(c, n_layers=m), cut, m)
               for name, c in (("kernel", cp), ("plain", cx))}
        for i, (o, w) in enumerate(zip(got["kernel"], got["plain"])):
            _check_rel(f"entry points at depth {m}, output {i}", o, w)
        log("parity", f"b. entry points at depth {m}: prefill + {n_dec} decode steps, logits "
            f"err / max |logit| {drift(got['kernel'], got['plain']):.3e} (tol "
            f"{PARITY_REL_TOL}) ok; {m} flash_attention per prefill, {m} decode_attention "
            "per decode step")

        # c. the entry points at full depth, beside the control
        got = {name: run_entry_points(name, c, prm, n) for name, (c, prm) in routes.items()}
        dk, dc = drift(got["kernel"], got["plain"]), drift(got["control"], got["plain"])
        top = float(got["plain"][0].abs().max())
        if dk > max(CHAOS_FACTOR * dc, PARITY_REL_TOL):
            raise AssertionError(f"entry points at depth {n}: the kernel route drifts {dk:.3e}, "
                                 f"more than {CHAOS_FACTOR} x the control's {dc:.3e}")
        log("parity", f"c. entry points at depth {n}: logits drift from the plain route (max "
            f"err / max |logit|; prefill max |logit| {top:.1f}): kernel route {dk:.3e}, "
            f"control (plain route, input nudged one f32 step) {dc:.3e}; within "
            f"{CHAOS_FACTOR} x the control, ok")
    del params, nudged, routes, cut, got
    torch.cuda.empty_cache()


def phase_serve() -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    ops.reset_launches()
    summary = serve.main(SERVE_ARGS)
    launches = ops.launches()
    n_layers = get_config("gemma-2b").n_layers
    n_req = int(SERVE_ARGS[SERVE_ARGS.index("--requests") + 1])
    max_new = int(SERVE_ARGS[SERVE_ARGS.index("--max-new") + 1])
    if summary["completed"] != n_req or summary["tokens"] != n_req * max_new:
        raise AssertionError(f"serve: {summary['completed']}/{n_req} requests, "
                             f"{summary['tokens']} tokens")
    want = {"flash_attention": summary["prefills"] * n_layers,
            "decode_attention": summary["decode_ticks"] * n_layers}
    if launches != want or min(launches.values()) == 0:
        raise AssertionError(f"serve launches {launches}, want {want}")
    log("serve", f"gemma-2b {summary['dtype']} full width: {summary['completed']}/{n_req} "
        f"requests, {summary['tokens']} tokens in {summary['wall_s']}s = "
        f"{summary['tokens_per_s']} tokens/s; latency p50 {summary['latency_p50_s']:.3f}s "
        f"p99 {summary['latency_p99_s']:.3f}s; {summary['prefills']} prefills, "
        f"{summary['decode_ticks']} decode ticks")
    log("serve", f"wrapper calls (launches) on the main path: {launches} "
        f"({launches['flash_attention'] / n_req} and {launches['decode_attention'] / n_req} "
        "per request)")
    return {"summary": summary, "launches": launches, "requests": n_req}


def phase_timing(worst: dict, serve: dict) -> list:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops

    def measure(fns):  # timed at once: the callables close over this block's tensors
        return {"dev": {key: device_ms(fn) for key, fn in fns.items()},
                "call": {key: call_ms(fn) for key, fn in fns.items()}}

    bf16 = torch.bfloat16
    item = 2  # bytes per bf16 element
    rows = []

    # K1 at the serve prefill: one request of 512 tokens, gemma's heads
    b, s, hq, hkv, d = 1, 512, 8, 1, 256
    q, k, v = _flash_inputs(b, s, hq, hkv, d, bf16, seed=7)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    # bytes: q, k, v read once and out written once; FLOPs: q.k and p.v over
    # the causal pairs, 2 * D each: 4 * B * Hq * D * S (S + 1) / 2
    nbytes = item * (2 * b * s * hq * d + 2 * b * s * hkv * d)
    flops = 4 * b * hq * d * s * (s + 1) / 2
    rows.append(dict(
        name="flash_attention", source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:34",
        **measure({"ms": lambda: ops.flash_attention(q, k, v),
                   "plain_ms": lambda: flash_plain(q, k, v),
                   "library_ms": lambda: F.scaled_dot_product_attention(
                       qt, kt, vt, is_causal=True, enable_gqa=True)}),
        nbytes=nbytes, flops=flops, shape=f"B={b} S={s} Hq={hq} Hkv={hkv} D={d} bf16"))

    # K2 at the serve decode tick: 8 slots, cache of 1024, valid lengths
    # 512..543 over the run; timed at their mean, 528
    b, m, length = 8, 1024, 528
    q, ck, cv, lens = _decode_inputs(b, m, hq, hkv, d, bf16, 8, [length] * b)
    qt = q.transpose(1, 2).contiguous()
    kt, vt = ck.transpose(1, 2).contiguous(), cv.transpose(1, 2).contiguous()
    mask = (torch.arange(m, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
    # bytes: q once, the valid K/V slots once, lengths, out; FLOPs: 4 * D per
    # (query head, valid slot)
    nbytes = item * (2 * b * hq * d + 2 * b * length * hkv * d) + 4 * b
    flops = 4 * b * hq * length * d
    rows.append(dict(
        name="decode_attention", source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:29",
        **measure({"ms": lambda: ops.decode_attention(q, ck, cv, lens),
                   "plain_ms": lambda: decode_plain(q, ck, cv, lens),
                   "library_ms": lambda: F.scaled_dot_product_attention(
                       qt, kt, vt, attn_mask=mask, enable_gqa=True)}),
        nbytes=nbytes, flops=flops, shape=f"B={b} M={m} len={length} Hq={hq} Hkv={hkv} D={d} bf16"))

    out = []
    for r in rows:
        dev, call = r["dev"], r["call"]
        t_bytes = r["nbytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = r["flops"] / BF16_FLOPS * 1e3
        bound_ms, bound_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
        launches = serve["launches"][r["name"]]
        log("timing", f"{r['name']} at {r['shape']}: device time kernel {dev['ms'] * 1e3:.2f} us, "
            f"plain {dev['plain_ms'] * 1e3:.2f} us, library (sdpa) {dev['library_ms'] * 1e3:.2f} us; "
            f"per call, host included: kernel {call['ms'] * 1e3:.2f} us, plain "
            f"{call['plain_ms'] * 1e3:.2f} us, library {call['library_ms'] * 1e3:.2f} us; bound "
            f"{bound_ms * 1e3:.3f} us ({bound_by}: {r['nbytes']} B, {r['flops']:.4g} FLOP), "
            f"{launches / serve['requests']} wrapper calls per request, "
            f"{ops.GRIDS_PER_CALL[r['name']]} grid(s) each")
        # launches: wrapper calls on the main path; grids_per_call: the
        # __global__ kernels each call launches
        out.append({"name": r["name"], "route": "cuda", "source": r["source"],
                    "replaces": r["replaces"], "launches": launches,
                    "grids_per_call": ops.GRIDS_PER_CALL[r["name"]],
                    "max_abs_err": worst[r["name"]], "ms": dev["ms"], "plain_ms": dev["plain_ms"],
                    "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": dev["library_ms"],
                    "call_ms": call["ms"]})
    return out


def phase_breakdown() -> None:
    """One prefill and one full decode tick of the bf16 serve engine, with the
    device's busy time from the profiler against the host's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.serving import ServingEngine
    from repro_torch.steps import init_model

    cfg = get_config("gemma-2b", attention_impl="pallas")
    _, params = init_model(cfg, seed=0, max_seq=1024, device="cuda")
    eng = ServingEngine(cfg, params, max_batch=8, max_len=1024, prefill_len=512, device="cuda")
    g = torch.Generator().manual_seed(0)
    for _ in range(8):
        eng.submit(torch.randint(1, cfg.vocab, (512,), generator=g).tolist(), max_new_tokens=64)
    eng.step()  # admit all 8 + first tick, warms everything up
    for _ in range(2):
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy_us = sum(e.self_device_time_total for e in events)
    n_kernels = sum(e.count for e in events)
    if busy_us <= 0:
        raise RuntimeError(f"decode tick (8 slots) {wall * 1e3:.2f} ms wall: the profiler saw "
                           "no device time")
    log("breakdown", f"decode tick (8 slots) {wall * 1e3:.2f} ms wall, device busy "
        f"{busy_us / 1e3:.2f} ms (idle share {1 - busy_us / 1e3 / (wall * 1e3):.3f}), "
        f"{n_kernels} device ops per tick")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:6]:
        log("breakdown", f"  {e.self_device_time_total / 1e3:.3f} ms "
            f"({100 * e.self_device_time_total / busy_us:.1f}% of busy) x{e.count} {e.key[:90]}")
    del eng, params
    torch.cuda.empty_cache()


def main() -> int:
    t_start = time.perf_counter()
    smi = phase_device()
    import torch

    phase_build()
    worst = phase_kernels()
    phase_parity()
    serve = phase_serve()
    kernels = phase_timing(worst, serve)
    phase_breakdown()
    log("done", f"all phases passed in {time.perf_counter() - t_start:.1f}s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
