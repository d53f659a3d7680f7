#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (``src/repro_torch``).

    python3 chip_smoke.py        # needs one CUDA card (sm_90) and nvcc

Phases, in order; any failure exits non-zero with its traceback:

1. device    - require CUDA and an sm_90 card; print versions and
               ``nvidia-smi --query-gpu=name,power.limit``.
2. build     - compile the kernels in ``src/repro_torch/kernels/csrc`` with
               nvcc for sm_90a (one process per source, in parallel); check
               in the SASS (cuobjdump) that K1's bf16 kernels issue wgmma
               and TMA loads and K2's cp.async, mma.sync and ldmatrix.
               Then ("fresh" lines), before any other phase loads the
               card, each kernel's device time at its main row of phase 6,
               and K3's again after 3 s of f32 matmuls.
3. kernels   - each CUDA kernel against its plain PyTorch version on the card:
               attention in f32 (tol 2e-5) and bf16 (tol 2e-2) at gemma's,
               hymba's, phi3-mini's (D=96) and nemotron-4's (D=192, G=12)
               head shapes, granite-moe's (24/8, D=64) and moonlight's
               (16/16, D=128), phi-3-vision's prefill (S = 1088, 32/32,
               D=96; cache 1152) and whisper's decoder (20/20, D=64; cache
               448), ragged shapes, S = 1 and 65, every head
               dim and GQA; decode also with NaN past lengths, a row of
               length 0 (output 0), G = 16 and lengths below the number of
               splits; the scans (K3, K4) in f32 (tol 2e-5) at hymba's
               serve prefill shape, a ragged S and B=3, S over 1024, B and C
               staged in 4-byte copies (N = 2, and views one float into a
               projection), and with identity steps at the end, which must
               leave h_last as it was.
4. parity    - gemma-2b, hymba-1.5b (both prefill scans), then phi3-mini-3.8b,
               granite-moe-3b-a800m, moonshot-v1-16b-a3b, phi-3-vision-4.2b
               (576 stub image rows ahead of the prompt) and whisper-large-v3
               (its encoder over 1500 stub frames, cut to 4 layers too, held
               to the plain route's with no launch) with their depth cut to
               4 layers, at full width
               in f32: prefill + 4 decode steps through the kernels
               (attention_impl="pallas") and through plain PyTorch ("xla",
               the scans through their plain versions): every layer and the
               logits on the same input, and the entry points at a cut depth,
               relative to max |reference|; after every depth and at full
               depth, the drift beside a control that perturbs the plain
               route's input at f32 rounding.  The launch counters must rise
               by n_layers per prefill and per decode step, for each kernel on
               the route, and stay at 0 on the plain route.  The moe family
               records every router call on both routes on the same input: a
               token whose experts differ must be a near-tie on the plain
               route (logit gap <= FLIP_GAP), a token whose kept experts
               alone differ must share its group with such a flip; those
               tokens are counted and left out of the 1e-5 checks (every
               token's MoE input is held).  The depth chains and the full
               depth are held to the control as for the other families.
4b. xlstm    - xlstm-125m at full width and depth in f32, card against
               CPU on the same params and tokens (B = 2, S = 256, then 8
               decode steps): every layer on the same input logged, the
               chain through the entry points held to 10x a control (the
               CPU route, its input nudged one f32 step); no launch (the
               family has no kernel route, in the reference either).
5. serve     - ``repro_torch.launch.serve.main`` at full width in bf16 (8
               slots, 512-token prompts, 32 new tokens each): gemma-2b (K1,
               K2), hymba-1.5b with the default scan (K1, K4, K2) and with
               ``--scan-impl chunked`` (K1, K3, K2), 16 requests each, and
               phi3-mini-3.8b (K1, K2 at D = 96), 8 requests, and
               granite-moe-3b-a800m (K1, K2 at 24/8, D = 64; the MoE in
               plain PyTorch), 16 requests, and xlstm-125m (no kernel:
               every counter must stay at 0), 16 requests; every
               request must complete and every prefill/decode must have gone
               through the kernels (counters set to 0 before each run).
5b. decode   - the families the engine does not serve (vlm, encdec) through
               ``init_model``, ``decoding.prefill`` and 32 greedy
               ``decode_step``s at full width and depth in bf16, B = 8:
               phi-3-vision-4.2b (576 stub image rows + 512 tokens, cache
               1152) and whisper-large-v3 (1500 stub frames, 192-token
               prompts, cache and position table 448): finite tokens for
               every row, exactly n_layers K1 launches in the prefill and
               n_layers K2 launches a step; prefill and step time, tokens/s,
               peak memory, whisper's encoder's share of the prefill.  Then,
               with the model loaded, phase 7's profiles of one prefill and
               one step (and of whisper's encoder alone).
5c. window   - hymba-1.5b at full width and depth in bf16 in its long mode
               (``window = cfg.long_window`` = 1024 slots): a windowed
               prefill of B = 2 x 1536 tokens (past the window, S % 1024 =
               512, so the reference's eviction fault R2 is on the path),
               then 32 greedy ``decode_step(window=...)``: no K1 in the
               prefill (the reference's rule), 32 K2 launches a step, every
               one at lengths 1024, a 1024-slot cache, finite tokens;
               prefill and step ms, peak memory; one of each profiled.
6. timing    - each kernel at its serve shapes: its device time (profiler;
               each op at its mean over the records a session kept), the same
               from CUDA events around calls queued behind a sleep (a
               cross-check), and time per call (CUDA events, host launch
               cost included),
               the same for its plain version and, for attention, for
               scaled_dot_product_attention (a yardstick the port never
               calls), and the roofline bound (bytes, FLOPs and, for K3, its
               exps on the SFU at the card's max SM clock); each kernel's
               time over the library's and its bound over its time; K1 and
               K2 also at phi3-mini's, nemotron-4's and granite-moe's heads,
               and at phase 5b's shapes (phi-3-vision, whisper), and K2 at
               phase 5c's step (B = 2, 1024 valid slots of 1024).
7. breakdown - profiles of the prefill (1 x 512 tokens) and the decode tick
               of the archs in BREAKDOWN_ARCHS (gemma-2b, hymba-1.5b and
               granite-moe-3b-a800m) in the bf16 serve engine: the top
               six device ops and the port's kernels wherever they rank;
               for granite-moe also the device time of its MoE layers,
               router and expert FFNs (the rest of the layer is the
               capacity dispatch and combine) and each step's bound.
8. train     - ``repro_torch.launch.train.train`` on the card, which calls
               no kernel (the launch counters must not move): (a) gemma-2b
               at full width in bf16, B=4, S=512, 4 AdamW steps without
               remat: finite losses and grad norms, every param leaf moved
               by step 1; ms/step over steps 2-4, tokens/s, peak memory and
               the step's bound; then one such step profiled, and its
               forward, backward and AdamW update timed apart.  (b) gemma-2b
               at full width cut to 2 layers in f32, B=1, S=128, wq and wk
               rescaled so the scores are O(1): one step on the card and
               one on the CPU from the same params: loss and grad norm
               within 1e-5 relative, every moment and new param within 2e-4
               of its leaf's max |x| (new params near a zero grad aside, see
               ``_parity_faults``); the gate must reject a step on half the
               tokens.  (c) the smoke config with checkpoints: a crash at
               step 6 (a checkpoint every 4), then a resume from step 4
               whose losses match an uninterrupted run's within 1e-6
               relative.  (d) hymba-1.5b at full width in bf16, B=2,
               S=512, remat, 4 steps on each training scan (``assoc``,
               ``chunked``: the reference's differentiable scans, no K3 or
               K4), and xlstm-125m, B=4, S=512, 4 steps: finite losses,
               every leaf moved, ms/step and peak memory.  (e) (b) for
               hymba-1.5b cut to 2 layers.
9. bridge    - the ``jaxlocal`` resource manager of the port
               (``repro_torch.core.backends.jaxlocal``) on the card, driven
               only through its slurm REST routes (``RestServer.handle``
               with the Bearer header and the paths the Bridge's adapter
               sends): a serve job of gemma-2b at full width in bf16 through
               K1 and K2 (``config_overrides`` restore its published config,
               ``attention_impl`` pallas; phase 5's 8 slots, 512-token
               prompts and 1024-slot cache), healthy, then 16 invokes of 32
               tokens from 8 threads: every one 32 tokens served by the
               job, K1 launches = 18 x 16, K2 a multiple of 18 and at least
               18 x 31 (counters set to 0 before the submit); tokens/s and
               p50/p99 latency over REST beside phase 5's, and the time of
               one ``GET /health`` (the REST layer alone); then DELETE and
               CANCELLED.  The same prompts then go through a
               ``ServingEngine`` built directly on the same seed's params,
               and each request's tokens over REST must equal its tokens
               there (a prefill is one row and a decode tick always all 8
               slots, so a request's arithmetic does not depend on its
               slot or its neighbours).  A train job at full width (B=4, S=512, 4 steps,
               no remat, no checkpoint): COMPLETED, finite losses, no
               launch.  The smoke config's crash at step 6 (a checkpoint
               every 4): FAILED with the job's reason, then a resubmission
               that starts at step 4 with losses within 1e-6 relative of an
               uninterrupted job's.  A FAILED job, another HTTP status or a
               request past ``BRIDGE_TIMEOUT`` fails the phase.
10. cells    - the dry-run's cells on the card (``launch/dryrun.py``; its
               accounting runs on ``meta`` in a process of its own, started
               after phase 2, which sees no card).  hymba-1.5b's
               prefill_32k cell under the reference's perf override
               (attention_impl="blockwise", the chunked scan: K3 in every
               layer), B cut from 32 to 1, S = 32768: (a) at 4 layers in
               f32, the blockwise route held against the K1 route layer by
               layer on the same input and at the logits (PARITY_REL_TOL),
               K3 4 launches on both routes, K1 4 and 0; its window mode
               (1024) against the plain windowed route at S = 4096.  (b) At
               full depth in bf16 through ``make_prefill_step`` on both
               routes: prefill ms, tokens/s, peak memory, K3 32 launches on
               both and K1 32 on the K1 route only; K1 and K3 at this shape
               beside sdpa and their bounds; K1's first, middle and last
               64 query rows against its plain arithmetic and K3's y and
               h_last against the chunked scan's, each relative to its max
               |want| (TOL of the type).  (c) The window mode at full
               length: a blockwise windowed prefill, then 32 greedy steps
               through K2 (32 launches a step) on the 1024-slot cache,
               finite tokens; one K2 call at this shape, every slot valid,
               against its plain version, relative to its max |want|.
               (d) The dry-run's records against the card: (b)'s blockwise
               run and gemma-2b's train_4k cell at B = 2 (B = 1 if the
               dry-run predicts over 70 GiB), remat: each run on the card
               under the same counter; the predicted peak within 10% of
               ``torch.cuda.max_memory_allocated``, the FLOPs equal to the
               meta count; the roofline terms and the bound's share of the
               measured time.
11. mesh     - the sharded prefill and decode bundles (``steps.py`` with a
               mesh: DTensor params, batch and cache, K1, K2 and K4 in
               ``local_map`` islands) on a (1, 1) mesh over NCCL, a process
               group of one rank (one card holds no multi-rank mesh: NCCL
               refuses two ranks on a device and gloo has no all-gather of
               CUDA tensors).  gemma-2b and hymba-1.5b (the default scan,
               K4) at full width, their depths cut to MESH_DENSE_LAYERS and
               MESH_HYBRID_LAYERS for the script's time, bf16, B =
               8, 512-token prompts, 32 greedy decode steps, each run
               through the same bundles with ``mesh=None`` first: the tokens equal, the logits within the
               bf16 tolerance, every wrapper's launches equal (counters set
               to 0 before each run: K1 and K4 n_layers, K2 32 x n_layers),
               prefill and step ms of both (the step's DTensor host
               overhead), and the bytes gathered per step (0 on one rank;
               beside them the bytes a (1, m) mesh would gather, from the
               specs).  Then K1 and K2 held against their plain versions
               at the local shapes of a "model" axis at full width, one
               rank's heads at a time in one process: gemma-2b at model =
               2 and 4 (Hq 4 and 2, Hkv 1, D = 256) and hymba-1.5b at 5 (Hq
               5, Hkv 1, D = 64), the ranks' outputs together equal to the
               plain version on all heads.
12. mesh-train - the sharded train step (``make_train_step`` with a mesh:
               tp, ZeRO-1, remat; the grads reduced to their params'
               placements, the moments placed by ``opt_pspecs``) on a (1, 1)
               NCCL mesh against the same steps with ``mesh=None``, bf16,
               full width, B x S = MESH_TRAIN_B x MESH_TRAIN_S, each run
               from ``init_model``'s seed-0 params on the synthetic batches,
               one run on the card at a time (the other's params kept on
               the host): gemma-2b 3 steps and hymba-1.5b (its Mamba mixer
               through the differentiable scans, DTensor in and out) 2, each
               at the depth MESH_TRAIN_RUNS gives.  Losses and grad norms
               within the bf16 tolerance (relative), every param within it
               of its max |x|, no kernel launched; ms a step of both, peak
               memory, the bytes the grads' reduction and ZeRO-1's gather
               moved a step (0 on one rank), and those a rank of an
               (MESH_TRAIN_DP, 1) mesh would move (from the specs).  Then
               gemma-2b's trained opt state and params saved from the mesh
               (``CheckpointManager.save`` of DTensors) to an in-memory
               ``ObjectStore`` and restored, the opt state with its
               ``opt_pspecs`` and the params onto ``make_prefill_step``'s
               ``in_shardings[0]`` (reshard-on-load), both bit for bit, with
               the save and restore times; the restored params prefill B =
               8 x 512 tokens and take 32 greedy steps through the mesh
               bundles and ``mesh=None`` (phase 11's ``_mesh_run``): tokens
               equal, logits within the bf16 tolerance, K1 n_layers and K2
               32 x n_layers launches on both.
13. mesh-families - the moe, vlm, encdec and ssm families on phase 11's
               (1, 1) NCCL mesh (one process group and mesh serve phases
               11-13), full width, bf16, each model alone on the card.
               (a) granite-moe-3b-a800m (4 layers; its MoE's dispatch and
               expert FFNs in their ``local_map`` island, the router's
               logits gathered whole), phi-3-vision-4.2b (4 layers, 576
               stub image rows + 512 tokens, cache 1152), whisper-large-v3
               (4 + 4 layers, 1500 stub frames, 192-token prompts, cache
               448) and xlstm-125m (4 layers: three mLSTM blocks, then the
               sLSTM; 128-token prompts, cache 160), B = 8, 32 greedy
               steps, through the mesh bundles and ``mesh=None`` on the
               same seed-0 params: tokens equal, logits
               within the bf16 tolerance, K1 n_layers and K2 32 x n_layers
               launches on both routes (every counter 0 for xlstm), the
               cache placed by the decode bundle's ``out_shardings``;
               prefill and step ms and peak memory of both.  (b)
               granite-moe at 2 layers, B x S = MESH_TRAIN_B x
               MESH_TRAIN_S, 2 steps (tp, ZeRO-1, remat) through
               ``make_train_step(cfg, mesh, ...)`` against ``mesh=None``:
               losses, aux and grad norms within the bf16 tolerance, every
               param within it of its max |x|, no launch; ms a step, and
               the bytes a rank of a (1, MESH_MOE_MODEL) mesh would send
               into the MoE's reduction over "model" (from the specs).
               (c) K1 and K2 at the local heads of a "model" axis, one
               rank's heads at a time: granite-moe (24/8, D = 64) at 2, 4,
               8, phi-3-vision (32/32, D = 96) at 2, 4 and whisper's
               decoder (20/20, D = 64) at 2, 4, 5, each at (a)'s prompt
               and cache, the ranks together equal to the plain version.
14. mesh-dryrun - the dry-run on a mesh against the card: phase 11's
               gemma-2b bundle (MESH_DENSE_LAYERS layers, K1/K2, bf16, B =
               MESH_BATCH) counted on ``meta`` as rank 0 of a fake (1, 1)
               group in a process of its own that sees no card (started
               beside the build), and run on phase 11's NCCL mesh under
               ``StepCost(device="cuda")``: a MESH_PROMPT-token prefill
               and one decode step on MESH_DRYRUN_SLOTS slots, each after
               ``reset_peak_memory_stats``.  FLOPs, bytes, input bytes,
               kernel calls and collectives equal the fake count; the peak
               within PEAK_REL_TOL of ``max_memory_allocated``; K1 and K2
               launches those of phase 11's prefill and of one of its
               steps.  The same process counts MESH_DRYRUN_CELL at full
               width on 16 x 16 and 2 x 16 x 16: per-device peak, hbm_fit,
               collectives by kind and count time, logged.
15. mesh-ep - expert parallelism on phase 11's (1, 1) NCCL mesh, granite-
               moe-3b-a800m at full width.  (a) f32 at PARITY_DEPTH layers,
               B = MESH_BATCH, a 512-token prefill and EP_PARITY_STEPS
               steps fed the dropping run's tokens, under "dropping",
               ``ep_gather`` and ``ep_shard_map``: logits within
               PARITY_REL_TOL of dropping's, launches equal; one train
               step's loss under ``ep_gather`` within PARITY_REL_TOL of
               dropping's.  (b) phase 13's bf16 run (4 layers, 32 steps)
               under both routes, fed phase 13's dropping tokens: logits
               within CHAOS_FACTOR x the drift of a dropping run whose
               input is nudged one f32 step (``_nudged``), K1 4 and K2 128
               as dropping's; greedy-token agreement, prefill and step ms
               logged.  (c) phase 13's 2-layer bf16 train step under
               ``ep_gather``: step 1's loss and aux within the bf16
               tolerance of dropping's; ms a step.  (d) ``pipeline_apply``
               (one stage) against the sequential loop, and
               ``compressed_mean`` equal to its definition, on CUDA tensors
               over the one-rank NCCL group (int8 on the wire).

The last three lines are the card's name and power limit, one JSON object
with the per-kernel numbers, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM published peaks (NVIDIA data sheet), for the roofline bound
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12  # outside the tensor cores
SFU_EXP_PER_CLOCK = 16  # MUFU.EX2 results per clock per SM (sm_90)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # tests/test_kernels.py::_tol
PARITY_REL_TOL = 1e-5  # full-width f32: max error / max |reference|
# layers of the cut model whose entry points are held to PARITY_REL_TOL: at 2,
# an f32 rounding of the input already grows to half that tolerance (gemma)
PARITY_DEPTH = 1
CHAOS_FACTOR = 10  # most kernel-route drift per unit of the control's drift
# moe: a token may take other experts on a kernel route, on the same input,
# only where the plain route's k-th and (k+1)-th router logits are this close
# (a kernel error at PARITY_REL_TOL moves a logit by ~1e-5)
FLIP_GAP = 1e-4

SERVE_COMMON = ["--full-width", "--attention-impl", "pallas", "--device", "cuda",
                "--max-batch", "8", "--prefill-len", "512", "--max-len", "1024",
                "--max-new", "32", "--json"]
# (label, launcher arguments); each is one main path.  phi3-mini serves one
# wave of 8 requests: its K1 and K2 run at D = 96
SERVE_RUNS = [
    ("gemma-2b", ["--arch", "gemma-2b", "--requests", "16"] + SERVE_COMMON),
    ("hymba-1.5b assoc", ["--arch", "hymba-1.5b", "--requests", "16"] + SERVE_COMMON),
    ("hymba-1.5b chunked", ["--arch", "hymba-1.5b", "--scan-impl", "chunked", "--requests", "16"]
     + SERVE_COMMON),
    ("phi3-mini-3.8b", ["--arch", "phi3-mini-3.8b", "--requests", "8"] + SERVE_COMMON),
    ("granite-moe-3b-a800m", ["--arch", "granite-moe-3b-a800m", "--requests", "16"]
     + SERVE_COMMON),
    ("xlstm-125m", ["--arch", "xlstm-125m", "--requests", "16"] + SERVE_COMMON),
]
# (arch, depth) of the full-width f32 parity runs; None keeps the published
# depth.  phi3-mini's 32 layers are cut to 4: its K1 and K2 at D = 96 are
# the point, and each layer adds seconds of plain f32 attention.  The moe
# family at 4 layers: granite-moe (GQA 24/8, D = 64, 40 experts top-8) and
# moonlight (MHA 16/16, D = 128, 64 experts top-6, 2 shared).  phi-3-vision
# (576 stub image rows ahead of the tokens) and whisper (4 encoder layers
# over 1500 stub frames, 4 decoder layers: K1 at 20/20, D = 64) at 4 layers
PARITY_RUNS = [("gemma-2b", None), ("hymba-1.5b", None), ("phi3-mini-3.8b", 4),
               ("granite-moe-3b-a800m", 4), ("moonshot-v1-16b-a3b", 4),
               ("phi-3-vision-4.2b", 4), ("whisper-large-v3", 4)]
# phase 8: (arch, batch, seq, steps) of the full-width run, (arch, layers,
# batch, seq) of the card-against-CPU step, and its tolerances
TRAIN_FULL = ("gemma-2b", 4, 512, 4)
TRAIN_PARITY = ("gemma-2b", 2, 1, 128)
# phase 8's other full-width bf16 runs: (arch, batch, seq, steps, remat,
# scan_impl): hymba-1.5b on each training scan, then xlstm-125m (no remat in
# the reference's xlstm stack); and the hybrid card-against-CPU step
TRAIN_MORE = [("hymba-1.5b", 2, 512, 4, True, "assoc"), ("hymba-1.5b", 2, 512, 4, True, "chunked"),
              ("xlstm-125m", 4, 512, 4, False, None)]
TRAIN_PARITY_HYBRID = ("hymba-1.5b", 2, 1, 128)
TRAIN_REL_TOL = 1e-5  # loss and grad norm, card against CPU
TRAIN_LEAF_TOL = 2e-4  # moments and new params: of the leaf's max |x|
RESUME_REL_TOL = 1e-6  # resumed losses against the uninterrupted run's
# the decode phase (5b): (arch, batch, prompt tokens, cache max_len) of the
# families the engine does not serve, each prefill + DECODE_STEPS greedy steps
# at full width and depth in bf16.  phi-3-vision: 576 image rows + 512 tokens
# (S = 1088); whisper: 1500 frames, 192-token prompts, max_len 448, its text
# context (arXiv:2212.04356), which also sizes its decoder position table
DECODE_RUNS = [("phi-3-vision-4.2b", 8, 512, 1152), ("whisper-large-v3", 8, 192, 448)]
DECODE_STEPS = 32
# the window decode phase (5c): (arch, batch, prompt tokens) of hymba-1.5b in
# its long_500k mode (a circular cache of cfg.long_window = 1024 slots): the
# prompt runs past the window with S % 1024 = 512, so the reference's
# eviction fault (ROADMAP.md R2) is on the path; then DECODE_STEPS steps
WINDOW_RUN = ("hymba-1.5b", 2, 1536)
# xlstm-125m card against CPU in f32 (phase 4b): (arch, batch, prompt, decode steps)
XLSTM_PARITY = ("xlstm-125m", 2, 256, 8)
# phase 9 (bridge): the jaxlocal twin driven over its slurm REST routes.
# Serve: (arch, requests, client threads, new tokens each) at phase 5's
# shapes (BRIDGE_SERVE_SHAPE: slots, prompt tokens, cache); train: (arch,
# batch, seq, steps) at full width, no remat, no checkpoint; then the smoke
# config's crash (at step 6, a checkpoint every 4) and resume
BRIDGE_SERVE = ("gemma-2b", 16, 8, 32)
BRIDGE_SERVE_SHAPE = (8, 512, 1024)
BRIDGE_TRAIN = ("gemma-2b", 4, 512, 4)
BRIDGE_TOKEN = "chip-smoke-token"
SLURM = "/slurm/v0.0.37"
# the slowest a REST request or job may take before the phase fails (s)
BRIDGE_TIMEOUT = 300
# phase 10 (cells): the dry-run's (arch, shape, batch) cells on the card.
# hymba-1.5b's prefill_32k cell under the reference's perf override
# (blockwise attention, the chunked scan: K3 in every layer), its batch cut
# from 32 to 1; held first at CELL_HELD_LAYERS layers in f32 against the
# K1 route (and its window mode against the plain one at CELL_WINDOW_HELD_S
# tokens); the window mode's prefill at full length, then DECODE_STEPS
# greedy steps through K2; and gemma-2b's train_4k cell, B cut from 256 to
# 2 (to 1 where the dry-run predicts more than TRAIN_CELL_MAX_BYTES)
CELL = ("hymba-1.5b", "prefill_32k", 1)
CELL_HELD_LAYERS = 4
CELL_WINDOW_HELD_S = 4096
TRAIN_CELL = ("gemma-2b", "train_4k", (2, 1))
TRAIN_CELL_MAX_BYTES = 70 * 2**30
PEAK_REL_TOL = 0.10  # the dry-run's peak against torch.cuda.max_memory_allocated
# phase 11: the sharded bundles on a (1, 1) mesh at full width; the depths
# are cut to keep the script within 420 s: hymba-1.5b's to MESH_HYBRID_LAYERS
# (on one H100 at 700 W, with hymba at full depth, its DTensor decode steps
# took 8-11 ms of host time a layer and the whole script 412.1-477.4 s), and
# gemma-2b's to MESH_DENSE_LAYERS to make room for phase 13 (at 18 layers
# its run took 7.4 s with init)
MESH_BATCH, MESH_PROMPT = 8, 512
MESH_HYBRID_LAYERS = 8
MESH_DENSE_LAYERS = 4
MESH_RUNS = [("gemma-2b", MESH_DENSE_LAYERS), ("hymba-1.5b", MESH_HYBRID_LAYERS)]
# the "model" axes whose gathered bytes phase 11 logs
MESH_MODEL_AXES = {"gemma-2b": (2, 4), "hymba-1.5b": (5,)}
# phase 12: the sharded train step (tp, ZeRO-1, remat) on a (1, 1) mesh at
# full width, bf16, B x S tokens a step: (arch, layers (None: the published
# depth), steps).  gemma-2b's trained state is then checkpointed, restored
# onto the serving bundles' shardings and served (phase 11's B, prompt and
# steps).  Both depths are cut for the phase's 45 s and the script's 420 s:
# on one H100 at 700 W, gemma-2b at its full 18 layers took 67.1 s, 50 s of
# it the round trip of its 25 GB of params and f32 moments through the
# in-memory store (~2.4 s a GB), and at 4 layers 29.2 s (the script 415.2
# s); hymba-1.5b keeps phase 11's cut
MESH_TRAIN_B, MESH_TRAIN_S = 4, 512
MESH_TRAIN_RUNS = [("gemma-2b", 2, 3), ("hymba-1.5b", MESH_HYBRID_LAYERS, 2)]
MESH_TRAIN_OPT = dict(lr=1e-4, warmup_steps=1, total_steps=10)
MESH_TRAIN_DP = 8  # the data axis of the (dp, 1) mesh whose bytes phase 12 computes
# phase 13: the moe, vlm, encdec and ssm families on phase 11's (1, 1) mesh,
# full width, bf16, B = MESH_BATCH, DECODE_STEPS greedy steps, through the
# mesh bundles and mesh=None on the same seed-0 params: (arch, layers
# (whisper's encoder cut alike), prompt tokens, cache slots).  granite-moe
# keeps phase 4's cut; phi-3-vision's prompt is its 576 stub image rows and
# 512 tokens, whisper's 1500 stub frames and 192 tokens (phase 5b's shapes);
# xlstm-125m's 4 layers are three mLSTM blocks and the sLSTM block of layer 4,
# its prompt cut to 128 tokens for the script's time (its sLSTM steps one
# token at a time, ~6-7 ms of DTensor dispatch a token on the mesh)
MESH_FAMILY_RUNS = [("granite-moe-3b-a800m", 4, 512, 544), ("phi-3-vision-4.2b", 4, 512, 1152),
                    ("whisper-large-v3", 4, 192, 448), ("xlstm-125m", 4, 128, 160)]
# granite-moe's train step on that mesh (tp, ZeRO-1, remat; MESH_TRAIN_B x
# MESH_TRAIN_S tokens): (arch, layers, steps); and the "model" axis of the
# (1, m) mesh whose MoE reduction bytes it computes from the specs
MESH_FAMILY_TRAIN = ("granite-moe-3b-a800m", 2, 2)
MESH_MOE_MODEL = 8
# K1 and K2 at the local heads of a "model" axis: (arch, model sizes), each at
# its MESH_FAMILY_RUNS prompt (S) and cache
MESH_FAMILY_HEADS = [("granite-moe-3b-a800m", (2, 4, 8)), ("phi-3-vision-4.2b", (2, 4)),
                     ("whisper-large-v3", (2, 4, 5))]
# phase 15: expert parallelism on phase 11's (1, 1) mesh.  (a) f32 at
# PARITY_DEPTH layers (EP_PARITY_STEPS decode steps fed the dropping run's
# tokens; one train step on MESH_TRAIN_B x MESH_TRAIN_S tokens), (b) phase
# 13's bf16 run of EP_ARCH under each route, fed phase 13's tokens, (c) phase
# 13's train step under ep_gather
EP_ARCH = "granite-moe-3b-a800m"
EP_ROUTES = ("ep_gather", "ep_shard_map")
EP_PARITY_STEPS = 4
# the pipeline's and the compressed mean's collectives on the one-rank group
EP_PIPE = dict(d=1536, layers=4, b=8, n_micro=4)
EP_COMP_NUMEL = 1536 * 512 + 3  # a grad-sized tensor, padded to no multiple
# the dry-run's accounting of phase 10's cells, run in a process of its own
# (on meta: no card) while the card works through phases 3-9
DRYRUN_SCRIPT = r"""
import dataclasses, json, sys
from repro_torch.configs.base import SHAPES, get_config
from repro_torch.launch import dryrun as D
(arch, shape, b), (tarch, tshape, tbs) = json.loads(sys.argv[1])
over = D._perf_overrides()
out = {"cell": D.account(arch, get_config(arch, **over[(arch, shape)]),
                         dataclasses.replace(SHAPES[shape], global_batch=b),
                         D.default_strategy(arch, shape), verbose=False)}
for bt in tbs:
    out[f"train {bt}"] = D.account(tarch, get_config(tarch, **over.get((tarch, tshape), {})),
                                   dataclasses.replace(SHAPES[tshape], global_batch=bt),
                                   D.default_strategy(tarch, tshape), verbose=False)
print("RESULT " + json.dumps(out))
"""
# phase 14: the dry-run on a mesh against the card.  Phase 11's gemma-2b bundle
# (MESH_DENSE_LAYERS layers, K1/K2, B = MESH_BATCH) counted on a fake (1, 1)
# group in a process of its own with no card, and run on phase 11's NCCL
# mesh under the counter: a MESH_PROMPT-token prefill, and one decode step
# on a cache of MESH_DRYRUN_SLOTS slots.  The same process counts
# MESH_DRYRUN_CELL at full width on 16 x 16 and 2 x 16 x 16 (logged only)
MESH_DRYRUN_SLOTS = 1024
MESH_DRYRUN_CELL = ("gemma-2b", "decode_32k")
MESH_DRYRUN_SCRIPT = r"""
import dataclasses, json, sys, time
from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_local_mesh
(arch, layers, b, prompt, slots), (carch, cshape) = json.loads(sys.argv[1])
cfg = dataclasses.replace(get_config(arch, attention_impl="pallas"), n_layers=layers)
out = {}
with D.fake_world(1):
    mesh = make_local_mesh(1, 1, device="cpu")
    for kind, seq in (("prefill", prompt), ("decode", slots)):
        t0 = time.time()
        c = D.count_cell(cfg, ShapeConfig(kind, seq, b, kind), mesh)
        out[kind] = {"flops": c.flops, "bytes": c.total_bytes, "peak": c.peak,
                     "input_bytes": c.input_bytes, "kernel_calls": c.kernel_calls,
                     "collectives": c.collectives(), "count_s": time.time() - t0}
for multi in (False, True):
    r = D.run_cell(carch, cshape, multi_pod=multi, verbose=False)
    out[r["mesh"]] = {k: r[k] for k in ("memory", "hbm_fit", "collectives", "count_s",
                                        "flops_per_dev", "n_chips", "accounting")}
print("RESULT " + json.dumps(out))
"""
# phase 7's profiled serve steps: gemma-2b, hymba-1.5b and granite-moe-3b-a800m
# (its MoE layer's parts).  xlstm-125m's profile (24.0 s on one H100 at 700 W)
# was cut to make room for phase 13: it gates nothing
BREAKDOWN_ARCHS = ("gemma-2b", "hymba-1.5b", "granite-moe-3b-a800m")
# phase 6's repeats of the plain versions (the kernels and the library calls
# keep device_ms's and call_ms's defaults): a plain scan call takes ~47 ms
# of host loop, and the plain times repeated within 2% between PRs 16 and 22
PLAIN_REPEATS = {"dev": {"iters": 5, "warmup": 1}, "call": {"iters": 10, "warmup": 1}}
# a kernel's profiled device time below this share of the CUDA events' time
# around the same calls (which read 3% below to 18% above it in earlier runs)
# is a profile that read short (0.43-0.57 was seen in 3 rows of 17): phase 6
# profiles it again, twice at most
SHORT_READ = 0.7
# the serve run whose counts stand in the kernels JSON as each kernel's launches
MAIN_PATH = {"flash_attention": "gemma-2b", "decode_attention": "gemma-2b",
             "ssm_scan": "hymba-1.5b assoc", "ssm_scan_fused": "hymba-1.5b chunked"}
# each kernel's source under src/repro_torch/kernels/csrc, and the Pallas
# kernel body it replaces
SOURCES = {"flash_attention": "flash_attention.cu", "decode_attention": "decode_attention.cu",
           "ssm_scan": "ssm_scan.cu", "ssm_scan_fused": "ssm_scan.cu"}
REPLACES = {"flash_attention": "src/repro/kernels/flash_attention.py:34",
            "decode_attention": "src/repro/kernels/decode_attention.py:29",
            "ssm_scan": "src/repro/kernels/ssm_scan.py:25",
            "ssm_scan_fused": "src/repro/kernels/ssm_scan.py:54"}


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


def queued_ms(fn, iters: int = 20) -> float:
    """Mean time per call of fn() from CUDA events around ``iters`` calls
    queued behind a sleep on the device that outlasts the host's queueing of
    them: the device ops run back to back, so the gaps between them count
    and the host's launch cost does not."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * host_s * 2e9) + 1_000_000)  # cycles: twice host_s at 2 GHz, + 0.5 ms
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# profiling sessions of device_ms, and those that lost device records
PROFILER = {"sessions": 0, "short": 0, "lost": 0}


def device_ms(fn, iters: int = 20, warmup: int = 5) -> float:
    """Mean device time per call of fn(), from the profiler: for each device
    op, its mean duration over the records the session kept, times the
    number of times one call runs it, its count over ``iters`` rounded.  A
    session can lose a few device records (late in this script on the H100,
    2 to 7 of a session's; see PROFILER), so a plain sum over ``iters``
    would read short.  A session that saw no device time at all is
    repeated, up to three in all; after three the time comes from CUDA
    events (``queued_ms``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    attempts = 3
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        device = [e for e in prof.key_averages()
                  if e.device_type.name == "CUDA" and e.count > 0]
        PROFILER["sessions"] += 1
        if sum(e.self_device_time_total for e in device) > 0:
            per_call = {e.key: max(round(e.count / iters), 1) for e in device}
            lost = sum(iters * per_call[e.key] - e.count for e in device)
            if lost > 0:
                PROFILER["short"] += 1
                PROFILER["lost"] += lost
            return sum(e.self_device_time_total / e.count * per_call[e.key]
                       for e in device) / 1e3
        log("timing", f"profiling session {attempt} of {attempts} saw no device time")
    ms = queued_ms(fn, iters)
    log("timing", f"timed from CUDA events behind a queued sleep instead: {ms * 1e3:.2f} us a call")
    return ms


def with_scan(cfg, scan_impl: str):
    import dataclasses

    return dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, scan_impl=scan_impl))


def expected_launches(cfg, prefills: int, decode_steps: int) -> dict:
    """Wrapper calls the kernel route of ``cfg`` makes: one per layer per
    prefill for K1 (and the hybrid's scan, K4 or K3), one per layer per
    decode step for K2; 0 for every kernel the route does not use."""
    from repro_torch.kernels import ops

    want = dict.fromkeys(ops.KERNELS, 0)
    if cfg.attention_impl != "pallas" or cfg.family == "ssm":  # xlstm reaches no kernel
        return want
    want["flash_attention"] = cfg.n_layers * prefills
    want["decode_attention"] = cfg.n_layers * decode_steps
    if cfg.family == "hybrid":
        scan = "ssm_scan" if cfg.ssm.scan_impl == "assoc" else "ssm_scan_fused"
        want[scan] = cfg.n_layers * prefills
    return want


@contextlib.contextmanager
def plain_scans():
    """The SSM scans through their plain versions on the card: the plain
    route's counterpart of attention_impl="xla" (the model picks its scan
    kernel by ``scan_impl`` alone).  The wrappers are restored on exit."""
    from repro_torch.kernels import ops, ref

    saved = ops.ssm_scan, ops.ssm_scan_fused
    ops.ssm_scan = ref.ssm_scan_ref
    ops.ssm_scan_fused = lambda delta, B, C, x, A: ref.ssm_scan_ref(
        *ref.ssm_discretize(delta, B, x, A), C)
    try:
        yield
    finally:
        ops.ssm_scan, ops.ssm_scan_fused = saved


@contextlib.contextmanager
def exact_attention():
    """The plain attention (``layers._plain_attention``) computed in f64 and
    rounded once to its input's dtype: the plain route without rounding in
    its attention, the yardstick that phase 4 logs beside encdec layers.
    Restored on exit."""
    import torch

    from repro_torch.models import layers as L

    plain = L._plain_attention

    def exact(q, k, v, mask, cfg):
        b, sq, hq, d = q.shape
        hkv = k.shape[2]
        qg = q.double().reshape(b, sq, hkv, hq // hkv, d)
        scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.double()) / math.sqrt(d)
        if mask is not None:
            scores = scores.masked_fill(~mask, float("-inf"))
        w = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhgqk,bkhd->bqhgd", w, v.double()).reshape(b, sq, hq, d)
        return out.to(q.dtype)

    L._plain_attention = exact
    try:
        yield
    finally:
        L._plain_attention = plain


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


# a kernel's name and template arguments in a demangled symbol
KERNEL_NAME = re.compile(r"\w+_kernel(<[^<>]*>)?")
# SASS opcodes that show each redesigned kernel's Hopper path: wgmma
# (HGMMA), TMA tile loads (UTMALDG), mbarriers (SYNCS), cp.async (LDGSTS),
# mma.sync (HMMA), ldmatrix (LDSM)
SASS_OPS = ("HGMMA", "UTMALDG", "SYNCS", "LDGSTS", "HMMA", "LDSM")
SASS_NEEDS = {"flash_fwd_wgmma_kernel": ("HGMMA", "UTMALDG", "SYNCS"),
              "decode_bf16_kernel": ("LDGSTS", "HMMA", "LDSM")}


def _short_names(mangled: list[str]) -> dict[str, str]:
    """Each mangled kernel symbol -> its name and template arguments, through
    the toolkit's demangler."""
    from repro_torch.kernels import _build

    cufilt = Path(_build.nvcc_path()).parent / "cu++filt"
    out = subprocess.run([str(cufilt)], input="\n".join(mangled) + "\n", capture_output=True,
                         text=True, timeout=60, check=True).stdout.splitlines()
    names = {}
    for m, d in zip(mangled, out, strict=True):
        short = KERNEL_NAME.search(d)
        names[m] = short.group(0) if short else d
    return names


def phase_build() -> None:
    from repro_torch.kernels import _build

    path, build_log, secs = _build.build()
    log("build", f"{len(_build.sources())} sources -> {path.relative_to(ROOT)} in {secs:.1f}s "
        f"({' '.join(_build.NVCC_FLAGS)})")
    entries = [line.split("'")[1] for line in build_log.splitlines()
               if "Compiling entry function" in line]
    sass = subprocess.run([str(Path(_build.nvcc_path()).parent / "cuobjdump"), "-sass", str(path)],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    blocks = sass.split("Function : ")[1:]
    names = _short_names(entries + [block.split(None, 1)[0] for block in blocks])
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            log("build", names[line.split("'")[1]])
        elif ("registers" in line or "spill" in line or "warning" in line.lower()
              or line.startswith("==")):
            log("build", line.strip())
    _build.library()
    # the machine code of the redesigned kernels, opcode counts per kernel
    seen = set()
    for block in blocks:
        name = names[block.split(None, 1)[0]]
        kind = name.split("<")[0]
        if kind not in SASS_NEEDS:
            continue
        counts = {op: len(re.findall(rf"\b{op}\b", block)) for op in SASS_OPS}
        missing = [op for op in SASS_NEEDS[kind] if counts[op] == 0]
        if missing:
            raise AssertionError(f"{name}: no {missing} in its SASS ({counts})")
        seen.add(kind)
        log("build", f"SASS {name}: " + ", ".join(f"{op} {n}" for op, n in counts.items() if n))
    if seen != set(SASS_NEEDS):
        raise AssertionError(f"SASS: found {sorted(seen)}, want {sorted(SASS_NEEDS)}")


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


def _scan_inputs(b, s, di, n, seed):
    """(delta, B, C, x, A) in f32, distributed as hymba's mixer makes them:
    delta = softplus(.) > 0, A = -exp(.) < 0, so dA = exp(delta A) in (0, 1)."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(seed)
    delta = F.softplus(torch.randn(b, s, di, generator=g, device="cuda"))
    B = torch.randn(b, s, n, generator=g, device="cuda")
    C = torch.randn(b, s, n, generator=g, device="cuda")
    x = torch.randn(b, s, di, generator=g, device="cuda")
    A = -torch.exp(torch.rand(di, n, generator=g, device="cuda") * 2 - 1)
    return delta, B, C, x, A


def flash_plain(q, k, v):
    from repro_torch.kernels import ref

    return ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2)).transpose(1, 2)


def decode_plain(q, ck, cv, lengths):
    from repro_torch.kernels import ref

    return ref.decode_attention_ref(q[:, 0], ck.transpose(1, 2), cv.transpose(1, 2),
                                    lengths)[:, None]


def fused_plain(delta, B, C, x, A):
    from repro_torch.kernels import ref

    return ref.ssm_scan_ref(*ref.ssm_discretize(delta, B, x, A), C)


def _k3_staging(B, C) -> str:
    """How K3 stages B and C rows in shared memory: 16-byte copies when N,
    the seq strides and every batch's bases are 16-byte multiples, else
    4-byte ones (the condition of ``vec16`` in csrc/ssm_scan.cu)."""
    n = B.shape[2]
    bases = [t.data_ptr() + 4 * i * t.stride(0) for t in (B, C) for i in range(t.shape[0])]
    wide = n % 4 == 0 and B.stride(1) % 4 == 0 and C.stride(1) % 4 == 0
    return "16-byte" if wide and all(p % 16 == 0 for p in bases) else "4-byte"


def _check_scans(worst: dict, shape, offset: int = 0) -> str:
    """K4 and K3 against their plain version at ``shape`` = (B,S,di,N).  With
    ``offset`` > 0, B and C are views into one projection of offset + 2N
    floats a step, starting ``offset`` floats in, as the model's B and C
    are views of its x projection.  Returns how K3 staged B and C."""
    import torch

    from repro_torch.kernels import ops, ref

    delta, B, C, x, A = _scan_inputs(*shape, seed=sum(shape))
    if offset:
        b, s, _, n = shape
        proj = torch.zeros(b, s, offset + 2 * n, device="cuda")
        proj[..., offset:offset + n], proj[..., offset + n:] = B, C
        B, C = proj[..., offset:offset + n], proj[..., offset + n:]
    dA, dBx = ref.ssm_discretize(delta, B, x, A)
    y_want, h_want = ref.ssm_scan_ref(dA, dBx, C)
    for name, out in (("ssm_scan", ops.ssm_scan(dA, dBx, C)),
                      ("ssm_scan_fused", ops.ssm_scan_fused(delta, B, C, x, A))):
        torch.cuda.synchronize()
        err = max(check_close(f"{name} {shape} y", out[0], y_want, "float32"),
                  check_close(f"{name} {shape} h_last", out[1], h_want, "float32"))
        worst[name] = max(worst[name], err)
        log("kernels", f"{name} f32 B,S,di,N={shape}"
            + (f", B and C views at float {offset} of a projection row" if offset else "")
            + f": max_abs_err {err:.3e} over y and h_last (max |y| "
            f"{float(y_want.abs().max()):.1f}; atol = rtol = 2e-05) ok"
            + (f"; K3 staged B and C in {_k3_staging(B, C)} copies" if name == "ssm_scan_fused"
               else ""))
    return _k3_staging(B, C)


def _check_identity_steps(shape, keep: int) -> None:
    """Identity steps after step ``keep`` (dA = 1, dBx = 0, C = 0 for K4;
    delta = 0, C = 0 for K3) leave h_last and the earlier y bit for bit as a
    scan of the first ``keep`` steps gives them, and give y = 0."""
    import torch

    from repro_torch.kernels import ops, ref

    delta, B, C, x, A = _scan_inputs(*shape, seed=7 + sum(shape))
    dA, dBx = ref.ssm_discretize(delta, B, x, A)
    short = {"ssm_scan": ops.ssm_scan(dA[:, :keep].contiguous(), dBx[:, :keep].contiguous(),
                                      C[:, :keep]),
             "ssm_scan_fused": ops.ssm_scan_fused(delta[:, :keep], B[:, :keep], C[:, :keep],
                                                  x[:, :keep], A)}
    dA[:, keep:], dBx[:, keep:], C[:, keep:], delta[:, keep:] = 1.0, 0.0, 0.0, 0.0
    full = {"ssm_scan": ops.ssm_scan(dA, dBx, C),
            "ssm_scan_fused": ops.ssm_scan_fused(delta, B, C, x, A)}
    torch.cuda.synchronize()
    for name, (y, h) in full.items():
        y0, h0 = short[name]
        if not (torch.equal(h, h0) and torch.equal(y[:, :keep], y0) and not bool(y[:, keep:].any())):
            raise AssertionError(f"{name} {shape}: identity steps after {keep} changed h_last "
                                 f"or y (max diff {max_err(h, h0):.3e})")
    log("kernels", f"ssm_scan and ssm_scan_fused B,S,di,N={shape}: identity steps after step "
        f"{keep} keep h_last and y bit for bit, y = 0 on them; ok")


def phase_kernels() -> dict:
    """Each kernel against its plain version; returns the worst error per kernel."""
    import torch

    from repro_torch.kernels import ops

    worst = dict.fromkeys(ops.KERNELS, 0.0)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        # gemma's heads (MQA, D=256), ragged S, GQA; hymba's heads (25/5, D=64);
        # one row, a tile and one row, and the head dims no model uses at full
        # width (bf16 runs those through the mma.sync path, 64-256 through wgmma)
        # phi3-mini's (32/32, D=96: half of the second 64-column chunk is
        # TMA's zero fill) and nemotron-4's (96/8, G=12, D=192: three chunks)
        for shape in [(1, 512, 8, 1, 256), (1, 77, 8, 1, 256), (2, 300, 8, 2, 128),
                      (1, 512, 25, 5, 64), (2, 77, 25, 5, 64), (1, 1, 8, 1, 256),
                      (2, 65, 8, 1, 256), (1, 65, 25, 5, 64), (2, 130, 4, 2, 16),
                      (1, 100, 4, 1, 32), (1, 200, 16, 4, 128),
                      (1, 512, 32, 32, 96), (2, 77, 32, 32, 96), (1, 512, 96, 8, 192),
                      (2, 77, 96, 8, 192),
                      # granite-moe's (24/8, G = 3, D = 64) and moonlight's (16/16, D = 128)
                      (1, 512, 24, 8, 64), (2, 77, 24, 8, 64), (1, 512, 16, 16, 128),
                      (2, 77, 16, 16, 128),
                      # phi-3-vision's prefill (576 image rows + 512 tokens, 32/32,
                      # D = 96) and whisper's decoder (20/20, D = 64, 192 tokens)
                      (1, 1088, 32, 32, 96), (8, 1088, 32, 32, 96), (8, 192, 20, 20, 64),
                      (2, 77, 20, 20, 64)]:
            q, k, v = _flash_inputs(*shape, dtype, seed=sum(shape))
            got = ops.flash_attention(q, k, v)
            torch.cuda.synchronize()
            err = check_close(f"flash_attention {name} {shape}", got, flash_plain(q, k, v), name)
            worst["flash_attention"] = max(worst["flash_attention"], err)
            log("kernels", f"flash_attention {name} B,S,Hq,Hkv,D={shape}: max_abs_err {err:.3e} "
                f"(atol = rtol = {TOL[name]}) ok")
        # a row of length 0 (its output is 0: the plain version, masking with
        # -inf, gives NaN there), G = 16, and lengths below the number of
        # splits (17 at B=8, Hkv=1 on 132 SMs)
        for shape, lengths in [((8, 1024, 8, 1, 256), [1, 17, 64, 300, 511, 512, 1000, 1024]),
                               ((3, 300, 8, 2, 128), [300, 129, 33]),
                               ((8, 1024, 25, 5, 64), [1, 33, 100, 512, 513, 530, 777, 1024]),
                               ((4, 256, 8, 1, 256), [0, 5, 256, 100]),
                               ((2, 512, 16, 1, 128), [512, 301]),
                               ((8, 1024, 8, 1, 256), [0, 1, 2, 3, 5, 7, 16, 31]),
                               ((3, 64, 32, 2, 64), [0, 64, 9]),
                               ((8, 1024, 32, 32, 96), [1, 33, 100, 512, 513, 530, 777, 1024]),
                               ((3, 300, 32, 32, 96), [0, 300, 17]),
                               ((8, 1024, 96, 8, 192), [1, 33, 100, 512, 513, 530, 777, 1024]),
                               ((4, 512, 96, 8, 192), [0, 5, 512, 300]),
                               ((8, 1024, 24, 8, 64), [1, 33, 100, 512, 513, 530, 777, 1024]),
                               ((3, 300, 24, 8, 64), [0, 300, 17]),
                               ((8, 1024, 16, 16, 128), [1, 33, 100, 512, 513, 530, 777, 1024]),
                               ((3, 300, 16, 16, 128), [0, 300, 17]),
                               # phi-3-vision's cache (1152) and whisper's (448)
                               ((8, 1152, 32, 32, 96), [1, 100, 576, 1088, 1089, 1100, 1119, 1152]),
                               ((8, 448, 20, 20, 64), [1, 17, 192, 193, 200, 223, 300, 448]),
                               ((3, 448, 20, 20, 64), [0, 448, 9])]:
            q, ck, cv, lens = _decode_inputs(*shape, dtype, sum(shape), lengths)
            live = lens > 0
            want = decode_plain(q[live], ck[live], cv[live], lens[live])
            got = ops.decode_attention(q, ck, cv, lens)
            torch.cuda.synchronize()
            if bool(got[~live].any()):
                raise AssertionError(f"decode_attention {name} {shape}: a row of length 0 "
                                     "is not 0")
            err = check_close(f"decode_attention {name} {shape}", got[live], want, name)
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
    # the scans take f32 only: hymba's serve prefill, a ragged S with B=3,
    # and S past one 512-step window of K3 (its carry between windows)
    for shape in [(1, 512, 3200, 16), (3, 77, 3200, 16), (2, 1100, 96, 16)]:
        _check_scans(worst, shape)
    # K3's 4-byte staging of B and C: N = 2 (not a multiple of 4), and N = 16
    # as views one float into a projection (misaligned bases), over two windows
    for shape, offset in [((2, 77, 96, 2), 0), ((2, 600, 96, 16), 1)]:
        if _check_scans(worst, shape, offset) != "4-byte":
            raise AssertionError(f"ssm_scan_fused {shape}: B and C did not take the 4-byte path")
    _check_identity_steps((1, 512, 3200, 16), keep=437)
    return worst


def _rel(got, want) -> float:
    """max |got - want| / max |want|; raises if got is misshapen or not finite."""
    import torch

    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{tuple(got.shape)} vs {tuple(want.shape)}, or not finite")
    return max_err(got, want) / float(want.abs().max())


def _hold(what: str, rel: float, tol: float = PARITY_REL_TOL) -> float:
    """rel, which must stay within ``tol``."""
    if rel > tol:
        raise AssertionError(f"{what}: max_abs_err / max |want| = {rel:.3e} > {tol}")
    return rel


def _check_rel(what: str, got, want, held=None) -> float:
    """_rel(got, want), which must stay within PARITY_REL_TOL.  With ``held``,
    a bool mask over the leading (B, S) dims, only the tokens it holds count
    (still relative to max |want| over all)."""
    rel = _rel(got, want)
    if held is not None:
        rel = max_err(got[held], want[held]) / float(want.abs().max()) if bool(held.any()) else 0.0
    return _hold(what, rel)


@contextlib.contextmanager
def routing_log():
    """Every MoE router call while it is open, recorded in order: its input
    (the normed stream after attention), its probs and its top-k experts.
    The router is restored on exit."""
    from repro_torch.models import moe as MOE

    calls, router = [], MOE._router

    def recording(p, x, cfg):
        probs, gates, idx = router(p, x, cfg)
        calls.append({"x": x, "probs": probs, "idx": idx})
        return probs, gates, idx

    MOE._router = recording
    try:
        yield calls
    finally:
        MOE._router = router


def new_tally() -> dict:
    return {"tokens": 0, "flips": 0, "queue": 0, "max_gap": 0.0, "pairs": 0, "dropped": 0}


def _expert_sets(call: dict, cfg) -> tuple:
    """(chosen, kept) of one router call: (B,S,E) masks of each token's top-k
    experts and of those its group's capacity kept."""
    import torch

    from repro_torch.models import moe as MOE

    idx, m = call["idx"], cfg.moe
    _, keep = MOE.queue_slots(idx, MOE.capacity(idx.shape[1], m), m.e_pad)
    none = torch.zeros(*idx.shape[:2], m.e_pad, dtype=torch.bool, device=idx.device)
    return none.scatter(2, idx, True), none.scatter(2, idx, keep)


def routing_diff(what: str, kern: dict, plain: dict, cfg, tally: dict):
    """(B,S) mask of the tokens whose routing differs between a kernel route's
    router call and the plain route's on the same input.  A token that took
    another set of experts (a flip) must be a near-tie on the plain route:
    its log-prob gap between the k-th and (k+1)-th expert (the logit gap) at
    most FLIP_GAP.  A token with the same
    experts but another kept set (the capacity queue moved behind a flip)
    must share its group (batch row) with a flip.  ``tally`` counts them,
    and the plain route's (token, choice) pairs and dropped pairs."""
    import torch

    (ck, kk), (cp, kp) = _expert_sets(kern, cfg), _expert_sets(plain, cfg)
    flip = (ck != cp).any(-1)
    queue = (kk != kp).any(-1) & ~flip
    logp = plain["probs"].log().sort(-1, descending=True).values
    k = cfg.moe.top_k
    gap = logp[..., k - 1] - logp[..., k]
    if bool((gap[flip] > FLIP_GAP).any()):
        raise AssertionError(f"{what}: a token took other experts where the plain route's "
                             f"k-th choice leads by {float(gap[flip].max()):.3e} > {FLIP_GAP}")
    if bool((queue & ~flip.any(1, keepdim=True)).any()):
        raise AssertionError(f"{what}: a token's kept experts moved with no flip in its group")
    tally["tokens"] += flip.numel()
    tally["flips"] += int(flip.sum())
    tally["queue"] += int(queue.sum())
    tally["pairs"] += int(cp.sum())
    tally["dropped"] += int((cp & ~kp).sum())
    if bool(flip.any()):
        tally["max_gap"] = max(tally["max_gap"], float(gap[flip].max()))
    return flip | queue


def held_tokens(what: str, kern: list, plain: list, cfg, tally: dict):
    """For router calls on the same input (the same stream and cache on both
    routes): every token's MoE input within PARITY_REL_TOL, then the (B,S)
    mask of the tokens whose routing agrees in every call (``routing_diff``).
    None where no MoE ran (the other families)."""
    held = None
    for ck, cp in zip(kern, plain, strict=True):
        _check_rel(f"{what}, MoE input", ck["x"], cp["x"])
        agree = ~routing_diff(what, ck, cp, cfg, tally)
        held = agree if held is None else held & agree
    return held


def _last(held):
    """The last token's entry of a (B,S) mask (the logits are the last token's)."""
    return None if held is None else held[:, -1:]


def _nudged(params: dict) -> dict:
    """params with layer 0's pre-attention norm scale moved one f32 step up
    (1 -> 1 + 2**-23): the model's input perturbed at f32 rounding.  Every
    other tensor is shared with ``params``."""
    import torch

    scale = params["blocks"]["ln_attn"]["scale"].clone()
    scale[0] = torch.nextafter(scale[0], torch.full_like(scale[0], float("inf")))
    blocks = {**params["blocks"], "ln_attn": {**params["blocks"]["ln_attn"], "scale": scale}}
    return {**params, "blocks": blocks}


def stub_inputs(cfg, tokens) -> dict:
    """{"tokens": tokens} and, for vlm and encdec, the stub frontend's
    embeddings (``with_frontend_stubs``, seed 0), on the tokens' device."""
    import numpy as np
    import torch

    from repro_torch.data import with_frontend_stubs

    stubs = with_frontend_stubs({"tokens": np.zeros(tuple(tokens.shape), np.int32)}, cfg)
    return {"tokens": tokens, **{k: torch.from_numpy(v).to(tokens.device)
                                 for k, v in stubs.items() if k != "tokens"}}


def _cut(params: dict, m: int) -> dict:
    """params with the decoder (and encoder) stacks cut to their first m layers."""
    from repro_torch.models.params import tree_map

    return {**params, **{key: tree_map(lambda t: t[:m], params[key])
                         for key in ("blocks", "enc_blocks") if key in params}}


def _entry_points(params: dict, cfg, inputs: dict, steps, max_len: int) -> list:
    """Logits of prefill (of ``inputs``: the tokens and the stub frontend's
    embeddings) and of each decode step, through the entry points."""
    from repro_torch.models import decoding as DEC

    out, cache = DEC.prefill(params, cfg, inputs, max_len=max_len)
    got = [out]
    for tok in steps:
        out, cache = DEC.decode_step(params, cfg, cache, tok)
        got.append(out)
    return got


def phase_parity(arch: str, depth=None) -> None:
    """Full-width ``arch`` in f32: kernel route(s) ("pallas") vs plain route
    ("xla", and for hymba the scans through their plain versions).  Hymba has
    two kernel routes, one per prefill scan (K4 for "assoc", K3 for
    "chunked").  ``depth`` cuts the model to that many layers ("full depth"
    below is then the cut depth).

    Under the reference's init (fan-in of wq/wk taken from the head dims, so
    q and k entries have a std far above 1) the random full-width model's
    attention scores are in the hundreds, and the model is chaotic in f32:
    a rounding-level change of its input grows layer after layer.  So each
    kernel route is held against the plain route in three ways:

    a. layer by layer on the same input (the plain route's stream and cache),
       through every layer, at prefill and at each of 4 decode steps, down
       to the logits, within PARITY_REL_TOL; and each layer's attention
       output alone (where K1 and K2 act) within PARITY_REL_TOL of the
       layer output's max;
    b. end to end through the entry points prefill/decode_step, with the
       model cut to PARITY_DEPTH layers, within PARITY_REL_TOL;
    c. end to end through the entry points at full depth, beside a control:
       the plain route with its input perturbed at f32 rounding (``_nudged``).
       A kernel route may drift no more than CHAOS_FACTOR times as far as
       the control does.
    Between a and b, each route and the control run on their own streams, and
    the prefill logits after every depth are held to the rule of c, so the
    run shows where the chaos sets in.

    vlm prompts are the 576 stub image rows and then the tokens; encdec
    runs its encoder over the 1500 stub frames first.  The encoder takes
    no kernel on any route: each route's encoder output is held to the
    plain route's, with no launch; "layers" and "depth" are the decoder's
    (b cuts the encoder too).  An encdec decoder layer runs its
    cross-attention after the kernel's self-attention, and that
    cross-attention (scores in the hundreds, near-ties) amplifies an f32
    rounding of its input 10-20x within the layer: an f64 self-attention
    moves the plain route's layer output by more than PARITY_REL_TOL.  So
    in a. its layers are held at their attention output alone; the whole
    layer and the logits are logged beside that of the plain route with
    exact (f64) attention (``exact_attention``); in b its entry points are
    held to the rule of c, beside the same yardstick.
    """
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import decoding as DEC
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as TF
    from repro_torch.models.params import count_params
    from repro_torch.steps import init_model

    cfg = get_config(arch, dtype="float32")
    cut = ""
    if depth is not None:
        cut = f" (depth cut from {cfg.n_layers} to {depth} layers)"
        # encdec: the encoder too
        cfg = dataclasses.replace(cfg, n_layers=depth, n_enc_layers=min(cfg.n_enc_layers, depth))
    cp = dataclasses.replace(cfg, attention_impl="pallas")
    cx = dataclasses.replace(cfg, attention_impl="xla")
    if cfg.family == "hybrid":
        kernel = {"kernel assoc": with_scan(cp, "assoc"), "kernel chunked": with_scan(cp, "chunked")}
    else:
        kernel = {"kernel": cp}
    # the cache holds the vlm's image rows too
    b, s, max_len, n_dec = 2, 128, 256 + cfg.n_img_tokens, 4
    t0 = time.perf_counter()
    defs, params = init_model(cfg, seed=0, max_seq=max_len, device="cuda")
    torch.cuda.synchronize()
    log("parity", f"{arch} f32, {count_params(defs) / 1e9:.3f}B params, {cfg.n_layers} layers{cut}, "
        f"init {time.perf_counter() - t0:.1f}s; prompt B={b} S={s}"
        + (f" after {cfg.n_img_tokens} stub image rows" if cfg.family == "vlm" else "")
        + (f" over {cfg.enc_frames} stub frames ({cfg.n_enc_layers} encoder layers)"
           if cfg.family == "encdec" else "")
        + f", {n_dec} decode steps; kernel routes {list(kernel)}")
    g = torch.Generator(device="cuda").manual_seed(1)
    inputs = stub_inputs(cfg, torch.randint(1, cfg.vocab, (b, s), generator=g, device="cuda"))
    steps = torch.randint(1, cfg.vocab, (n_dec, b, 1), generator=g, device="cuda")
    n = cfg.n_layers
    nudged = _nudged(params)
    routes = {**{name: (c, params) for name, c in kernel.items()},
              "plain": (cx, params), "control": (cx, nudged)}

    def on(name):
        """The context a route runs in: the plain scans for the plain routes."""
        return plain_scans() if name in ("plain", "control") else contextlib.nullcontext()

    def logits_of(x):
        return L.unembed(params["embed"], L.apply_norm(params["ln_f"], x[:, -1:], cfg.norm), cfg)

    def drift(got, want):
        return max(_rel(o, w) for o, w in zip(got, want))

    def run_entry_points(name, c, prm):
        ops.reset_launches()
        with on(name):
            got = _entry_points(prm, c, inputs, steps, max_len)
        want = expected_launches(c, 1, n_dec)
        if ops.launches() != want:
            raise AssertionError(f"{name} route launches {ops.launches()}, want {want}")
        return got

    # moe: the routing differences of each kernel route from the plain route
    # on the same input (a, b)
    tally = {name: new_tally() for name in kernel}

    with torch.no_grad():
        # encdec: each route's encoder output (no kernel on any route)
        encs = {}
        for name, (c, prm) in routes.items():
            ops.reset_launches()
            with on(name):
                encs[name] = TF.encoder_output(prm, c, inputs)
            if any(ops.launches().values()):
                raise AssertionError(f"{name} route's encoder launched {ops.launches()}")
        if cfg.family == "encdec":
            for name in kernel:
                rel = _check_rel(f"{name} encoder output", encs[name], encs["plain"])
                log("parity", f"{name} encoder ({cfg.n_enc_layers} layers, bidirectional, plain "
                    f"attention): output err / max |x| {rel:.3e}, no kernel launched; ok")
        enc = encs["plain"]
        # a. layer by layer on the same input, prefill then decode; for moe,
        # each token's MoE input is held for every token, the layer output
        # for the tokens whose routing agrees
        x, pos, _ = TF._embed_inputs(params, cfg, inputs)
        s_all = x.shape[1]  # the vlm's image rows and its tokens
        embed_rms = float(x.square().mean().sqrt())
        cache = DEC.init_cache(cfg, b, max_len, device="cuda")
        sub = cfg.family == "encdec"  # whole layers logged, not held (see above)
        worst = dict.fromkeys(kernel, 0.0)
        attn_worst = dict.fromkeys(kernel, 0.0)
        for li in range(n):
            p = TF.layer_params(params["blocks"], li)
            xn = L.apply_norm(p["ln_attn"], x, cfg.norm)
            attn = L.attn_forward(p["attn"], xn, pos, cx)[0]
            xk, calls, held, attn_err = {}, {}, {}, {}
            for name, c in kernel.items():
                attn_err[name] = max_err(L.attn_forward(p["attn"], xn, pos, c)[0], attn)
                with routing_log() as calls[name]:
                    xk[name] = TF._apply_block(p, x, pos, c, enc)[0]
            if sub:
                with exact_attention():
                    exact = TF._apply_block(p, x, pos, cx, enc)[0]
            with plain_scans(), routing_log() as plain_calls:
                x, (k, v), state, _ = TF._apply_block(p, x, pos, cx, enc)
            for name in kernel:
                what = f"{name} prefill layer {li}"
                attn_worst[name] = max(attn_worst[name], _hold(
                    f"{what} attention output", attn_err[name] / float(x.abs().max())))
                held[name] = held_tokens(what, calls[name], plain_calls, cfg, tally[name])
                if sub:
                    worst[name] = max(worst[name], _rel(xk[name], x))
                    worst["exact"] = max(worst.get("exact", 0.0), _rel(exact, x))
                else:
                    worst[name] = max(worst[name], _check_rel(what, xk[name], x, held[name]))
            cache["k"][li, :, :s_all], cache["v"][li, :, :s_all] = k, v
            for key, t in state.items():
                cache[key][li] = t
            if li == 0:
                layer0_rms = float(x.square().mean().sqrt())
        for name in kernel:
            if sub:
                rel = _rel(logits_of(xk[name]), logits_of(x))
                log("parity", f"a. {name} prefill, same input: worst attention output err / max "
                    f"|x| {attn_worst[name]:.3e} (tol {PARITY_REL_TOL}) ok; logged: worst "
                    f"layer output err / max |x| {worst[name]:.3e} (plain route with exact "
                    f"attention {worst['exact']:.3e}), logits err / max |logit| {rel:.3e}")
                continue
            rel = _check_rel(f"{name} prefill logits", logits_of(xk[name]), logits_of(x),
                             _last(held[name]))
            log("parity", f"a. {name} prefill, same input: worst layer output err / max |x| "
                f"{worst[name]:.3e}; logits err / max |logit| {rel:.3e} (tol {PARITY_REL_TOL}); "
                f"worst attention output err / max |x| {attn_worst[name]:.3e} ok")
        log("parity", f"rms of the embedded input {embed_rms:.2f}, of the stream after layer 0 "
            f"{layer0_rms:.2f}")
        cache["pos"].fill_(s_all)
        for i in range(n_dec):
            x = L.embed_tokens(params["embed"], steps[i], cfg)
            pos = cache["pos"]
            worst = dict.fromkeys(kernel, 0.0)
            # each layer's attention output alone (K2 and the output
            # projection) on the same input, and the worst layer it was in
            attn_worst = {name: (0.0, 0) for name in kernel}
            for li in range(n):
                p = TF.layer_params(params["blocks"], li)
                layer = {key: t[li] for key, t in cache.items() if key != "pos"}
                # each writes the same new K/V (computed before attention)
                # into the slot; the recurrent state is only read
                xn = L.apply_norm(p["ln_attn"], x, cfg.norm)
                attn = L.attn_decode(p["attn"], xn, layer["k"], layer["v"], pos, cx)[0]
                xk, calls, attn_err = {}, {}, {}
                for name, c in kernel.items():
                    attn_err[name] = max_err(L.attn_decode(p["attn"], xn, layer["k"], layer["v"],
                                                           pos, c)[0], attn)
                    with routing_log() as calls[name]:
                        xk[name] = DEC._decode_block(p, x, layer, pos, c)[0]
                if sub:
                    with exact_attention():
                        exact = DEC._decode_block(p, x, layer, pos, cx)[0]
                with routing_log() as plain_calls:
                    x, state = DEC._decode_block(p, x, layer, pos, cx)
                for name in kernel:
                    what = f"{name} decode {i + 1} layer {li}"
                    attn_worst[name] = max(attn_worst[name], (_hold(
                        f"{what} attention output", attn_err[name] / float(x.abs().max())), li))
                    held[name] = held_tokens(what, calls[name], plain_calls, cfg, tally[name])
                    if sub:
                        worst[name] = max(worst[name], _rel(xk[name], x))
                        worst["exact"] = max(worst.get("exact", 0.0), _rel(exact, x))
                    else:
                        worst[name] = max(worst[name], _check_rel(what, xk[name], x, held[name]))
                for key, t in state.items():
                    cache[key][li] = t
            if sub:
                log("parity", f"a. decode {i + 1}, same input: " + "; ".join(
                    f"{name} worst attention output err / max |x| "
                    f"{attn_worst[name][0]:.3e} (layer {attn_worst[name][1]})"
                    for name in kernel) + f" (tol {PARITY_REL_TOL}) ok; logged: " + "; ".join(
                    f"{name} worst layer err / max |x| {worst[name]:.3e}, logits "
                    f"{_rel(logits_of(xk[name]), logits_of(x)):.3e}" for name in kernel)
                    + f"; the plain route with exact attention: worst layer err "
                    f"{worst['exact']:.3e}, logits {_rel(logits_of(exact), logits_of(x)):.3e}")
            else:
                rels = {name: _check_rel(f"{name} decode {i + 1} logits", logits_of(xk[name]),
                                         logits_of(x), held[name]) for name in kernel}
                log("parity", f"a. decode {i + 1}, same input: " + "; ".join(
                    f"{name} worst layer err / max |x| {worst[name]:.3e}, logits "
                    f"{rels[name]:.3e}, worst attention output err / max |x| "
                    f"{attn_worst[name][0]:.3e} (layer {attn_worst[name][1]})"
                    for name in kernel) + f" (tol {PARITY_REL_TOL}) ok")
            cache["pos"] += 1
        del cache

        # each route on its own stream; the prefill logits after every depth
        x0, pos, _ = TF._embed_inputs(params, cfg, inputs)
        xs = dict.fromkeys(routes, x0)
        curve = {name: [] for name in kernel}
        for li in range(n):
            for name, (c, prm) in routes.items():
                with on(name):
                    xs[name] = TF._apply_block(TF.layer_params(prm["blocks"], li), xs[name],
                                               pos, c, encs[name])[0]
            want = logits_of(xs["plain"])
            dc = _rel(logits_of(xs["control"]), want)
            for name in kernel:
                dk = _rel(logits_of(xs[name]), want)
                if dk > max(CHAOS_FACTOR * dc, PARITY_REL_TOL):
                    raise AssertionError(f"{name} prefill at depth {li + 1}: drifts {dk:.3e}, "
                                         f"more than {CHAOS_FACTOR} x the control's {dc:.3e}")
                curve[name].append((dk, dc))
        for name in kernel:
            log("parity", f"{name}: prefill logits drift from the plain route by depth, kernel "
                "route / control: " + ", ".join(f"{i + 1}: {dk:.1e}/{dc:.1e}"
                                                 for i, (dk, dc) in enumerate(curve[name]))
                + f"; within {CHAOS_FACTOR} x the control at every depth, ok")
        del xs, encs, enc

        # b. the entry points with the model cut to PARITY_DEPTH layers.  moe:
        # at depth 1 a token's routing reaches its own output only (the cache
        # holds layer 0's K/V, made before its MoE), so an output is held
        # where its token's routing agrees
        m = PARITY_DEPTH
        cut = _cut(params, m)
        got, calls = {}, {}
        for name, c in (*kernel.items(), ("plain", cx)):
            with routing_log() as calls[name]:
                got[name] = run_entry_points(name, dataclasses.replace(c, n_layers=m), cut)
        if sub:  # encdec: the rule of c at depth m, beside the exact-attention yardstick
            cm = dataclasses.replace(cx, n_layers=m)
            dc = drift(run_entry_points("control", cm, _cut(nudged, m)), got["plain"])
            with exact_attention():
                de = drift(run_entry_points("plain", cm, cut), got["plain"])
        for name in kernel:
            if sub:
                dk = drift(got[name], got["plain"])
                if dk > max(CHAOS_FACTOR * dc, PARITY_REL_TOL):
                    raise AssertionError(f"{name} entry points at depth {m}: drift {dk:.3e}, more "
                                         f"than {CHAOS_FACTOR} x the control's {dc:.3e}")
                log("parity", f"b. {name} entry points at depth {m}: prefill + {n_dec} decode "
                    f"steps, logits drift from the plain route (max err / max |logit|) {dk:.3e}; "
                    f"control (input nudged one f32 step) {dc:.3e}, within {CHAOS_FACTOR} x, "
                    f"ok; the plain route with exact attention {de:.3e}")
                continue
            rels = []
            for i, (o, w) in enumerate(zip(got[name], got["plain"])):
                what = f"{name} entry points at depth {m}, output {i}"
                held = held_tokens(what, calls[name][i * m:(i + 1) * m],
                                   calls["plain"][i * m:(i + 1) * m], cfg, tally[name])
                rels.append(_check_rel(what, o, w, _last(held)))
            log("parity", f"b. {name} entry points at depth {m}: prefill + {n_dec} decode steps, "
                f"logits err / max |logit| {max(rels):.3e} (tol "
                f"{PARITY_REL_TOL}) ok; launches "
                f"{expected_launches(dataclasses.replace(kernel[name], n_layers=m), 1, n_dec)}")

        # c. the entry points at full depth, beside the control
        got = {name: run_entry_points(name, c, prm) for name, (c, prm) in routes.items()}
        dc = drift(got["control"], got["plain"])
        top = float(got["plain"][0].abs().max())
        for name in kernel:
            dk = drift(got[name], got["plain"])
            if dk > max(CHAOS_FACTOR * dc, PARITY_REL_TOL):
                raise AssertionError(f"{name} entry points at depth {n}: drifts {dk:.3e}, "
                                     f"more than {CHAOS_FACTOR} x the control's {dc:.3e}")
            log("parity", f"c. {name} entry points at depth {n}: logits drift from the plain "
                f"route (max err / max |logit|; prefill max |logit| {top:.1f}): kernel route "
                f"{dk:.3e}, control (plain route, input nudged one f32 step) {dc:.3e}; within "
                f"{CHAOS_FACTOR} x the control, ok")
    if cfg.family == "moe":
        for name, t in tally.items():
            log("parity", f"routing, {name} route on the plain route's input (a, b): {t['flips']} "
                f"of {t['tokens']} token-layers took another expert set, each a near-tie (plain-"
                f"route logit gap <= {FLIP_GAP}; largest {t['max_gap']:.3e}); {t['queue']} kept "
                "another set of the same experts (the capacity queue behind a flip); those "
                f"tokens' outputs not held, every token's MoE input held to {PARITY_REL_TOL}; the "
                f"plain route dropped {t['dropped']} of {t['pairs']} (token, choice) pairs")
    del params, nudged, routes, cut, got
    torch.cuda.empty_cache()


def phase_serve(label: str, args: list) -> dict:
    """One main path: the launcher at full width, counters set to 0 just
    before and read just after."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    arch = args[args.index("--arch") + 1]
    cfg = get_config(arch, attention_impl="pallas")
    if "--scan-impl" in args:
        cfg = with_scan(cfg, args[args.index("--scan-impl") + 1])
    n_req = int(args[args.index("--requests") + 1])
    max_new = int(args[args.index("--max-new") + 1])
    ops.reset_launches()
    summary = serve.main(args)
    launches = ops.launches()
    if summary["completed"] != n_req or summary["tokens"] != n_req * max_new:
        raise AssertionError(f"serve {label}: {summary['completed']}/{n_req} requests, "
                             f"{summary['tokens']} tokens")
    want = expected_launches(cfg, summary["prefills"], summary["decode_ticks"])
    if launches != want or any(launches[k] == 0 for k, v in want.items() if v):
        raise AssertionError(f"serve {label} launches {launches}, want {want}")
    log("serve", f"{label} {summary['dtype']} full width: {summary['completed']}/{n_req} "
        f"requests, {summary['tokens']} tokens in {summary['wall_s']}s = "
        f"{summary['tokens_per_s']} tokens/s; latency p50 {summary['latency_p50_s']:.3f}s "
        f"p99 {summary['latency_p99_s']:.3f}s; {summary['prefills']} prefills, "
        f"{summary['decode_ticks']} decode ticks")
    log("serve", f"{label} wrapper calls (launches) on the main path: {launches} " + (
        "(the xlstm family reaches no kernel, as in the reference)" if cfg.family == "ssm" else
        f"(= prefills x {cfg.n_layers} for the prefill kernels, decode ticks x {cfg.n_layers} "
        "for decode_attention)"))
    torch.cuda.empty_cache()
    return {"summary": summary, "launches": launches, "requests": n_req}


def phase_decode(arch: str, b: int, prompt: int, max_len: int) -> dict:
    """One main path of a family the engine does not serve (vlm, encdec):
    ``init_model``, ``decoding.prefill`` of ``b`` prompts of ``prompt`` tokens
    with the stub frontend's embeddings, then DECODE_STEPS greedy
    ``decode_step``s, at full width and depth in bf16.  Counters set to 0
    just before the prefill, read after it and after the steps: exactly
    n_layers K1 launches a prefill and n_layers K2 launches a step (the
    decoder's layers: whisper's encoder and cross-attention take none).
    Then the breakdown of phase 7 for the model while it is loaded: one
    prefill and one step profiled, and for encdec the encoder alone."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import decoding as DEC
    from repro_torch.models import transformer as TF
    from repro_torch.models.params import count_params
    from repro_torch.steps import init_model

    n_steps = DECODE_STEPS
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = get_config(arch, attention_impl="pallas")
    defs, params = init_model(cfg, seed=0, max_seq=max_len, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    inputs = stub_inputs(cfg, torch.randint(1, cfg.vocab, (b, prompt), generator=g, device="cuda"))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = cfg.n_layers

    ops.reset_launches()
    t0 = time.perf_counter()
    logits, cache = DEC.prefill(params, cfg, inputs, max_len=max_len)
    nxt = logits.argmax(-1)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    after_prefill = ops.launches()
    finite = torch.isfinite(logits).all()
    toks = []
    t0 = time.perf_counter()
    for _ in range(n_steps):
        logits, cache = DEC.decode_step(params, cfg, cache, nxt)
        nxt = logits.argmax(-1)
        finite &= torch.isfinite(logits).all()
        toks.append(nxt)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3
    launches = ops.launches()
    toks = torch.cat(toks, dim=1)
    want = expected_launches(cfg, 1, 0)
    if after_prefill != want:
        raise AssertionError(f"decode {arch}: prefill launches {after_prefill}, want {want}")
    want = expected_launches(cfg, 1, n_steps)
    if launches != want:
        raise AssertionError(f"decode {arch}: launches {launches}, want {want}")
    if not bool(finite) or tuple(toks.shape) != (b, n_steps) or not bool(
            ((toks >= 0) & (toks < cfg.vocab)).all()):
        raise AssertionError(f"decode {arch}: logits finite {bool(finite)}, tokens "
                             f"{tuple(toks.shape)} in [{int(toks.min())}, {int(toks.max())}]")
    rows = inputs["tokens"].shape[1] + cfg.n_img_tokens
    if int(cache["pos"][0]) != rows + n_steps:
        raise AssertionError(f"decode {arch}: pos {cache['pos'].tolist()} after {n_steps} steps")
    peak = torch.cuda.max_memory_allocated()
    kv = cache["k"].numel() * cache["k"].element_size() * 2
    cross = sum(cache[k].numel() * cache[k].element_size() for k in ("cross_k", "cross_v")
                if k in cache)
    out = {"launches": launches, "prefill_ms": prefill_ms, "step_ms": decode_ms / n_steps,
           "tokens_per_s": b * n_steps / (decode_ms / 1e3),
           "tokens_per_s_with_prefill": b * n_steps / ((prefill_ms + decode_ms) / 1e3),
           "peak_bytes": peak}
    what = (f"B={b}, {cfg.n_img_tokens} stub image rows + {prompt} tokens (S = {rows})"
            if cfg.family == "vlm" else
            f"B={b}, {cfg.enc_frames} stub frames, {prompt}-token prompts"
            if cfg.family == "encdec" else f"B={b}, {prompt}-token prompts")
    log("decode", f"{arch} {cfg.dtype} full width and depth ({count_params(defs) / 1e9:.3f}B "
        f"params, {n} decoder layers), {what}, cache max_len {max_len} (K/V {kv / 1e9:.2f} GB"
        + (f", cross K/V {cross / 1e9:.2f} GB" if cross else "") + f"); init {init_s:.1f}s")
    log("decode", f"{arch}: prefill {prefill_ms:.2f} ms, {n_steps} greedy decode steps "
        f"{decode_ms:.2f} ms = {out['step_ms']:.2f} ms a step, {out['tokens_per_s']:.1f} "
        f"tokens/s ({out['tokens_per_s_with_prefill']:.1f} with the prefill); peak memory "
        f"{peak / 2**30:.2f} GiB ({peak} bytes); {b} x {n_steps} finite tokens, first row "
        f"{toks[0, :8].tolist()}...")
    log("decode", f"{arch} launches: {after_prefill} after the prefill, {launches} after the "
        f"steps (= {n} a prefill for flash_attention, {n} a step for decode_attention)")
    with torch.no_grad():
        if cfg.family == "encdec":
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            TF.encode(params, cfg, inputs["enc_frames"])
            torch.cuda.synchronize()
            out["encoder_ms"] = (time.perf_counter() - t0) * 1e3
            if ops.launches() != launches:
                raise AssertionError(f"decode {arch}: the encoder launched a kernel")
            log("decode", f"{arch}: the encoder alone (a second call, {cfg.n_enc_layers} "
                f"layers over {cfg.enc_frames} frames, no kernel launched) "
                f"{out['encoder_ms']:.2f} ms = {out['encoder_ms'] / prefill_ms:.3f} of the "
                "prefill's wall time")
        prof = {"prefill": _profile(f"{arch} prefill ({what})",
                                    lambda: DEC.prefill(params, cfg, inputs, max_len=max_len)),
                "decode": _profile(f"{arch} decode step ({b} rows)",
                                   lambda: DEC.decode_step(params, cfg, cache, nxt))}
        if cfg.family == "encdec":
            prof["encoder"] = _profile(f"{arch} encoder ({b} x {cfg.enc_frames} frames)",
                                       lambda: TF.encode(params, cfg, inputs["enc_frames"]))
            log("breakdown", f"{arch}: encoder device busy {prof['encoder'][0]:.2f} ms = "
                f"{prof['encoder'][0] / prof['prefill'][0]:.3f} of the prefill's busy")
    out["busy_ms"] = {k: v[0] for k, v in prof.items()}
    out["wall_ms"] = {k: v[1] for k, v in prof.items()}
    del params, cache, logits, inputs
    torch.cuda.empty_cache()
    return out


def phase_window(arch: str, b: int, prompt: int) -> dict:
    """The sliding-window mode's main path: ``decoding.prefill`` of ``b``
    prompts of ``prompt`` tokens with ``window = cfg.long_window``, then
    DECODE_STEPS greedy ``decode_step(window=...)`` on the circular cache, at
    full width and depth in bf16.  Counters set to 0 just before the
    prefill, read after it and after the steps: the windowed prefill takes
    no K1 (the reference's rule: K1 only without a window) and one scan
    kernel a layer; each step takes n_layers K2 launches, every one with
    every row's length at the window (the cache is full).  Then one prefill
    and one step profiled."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import decoding as DEC
    from repro_torch.models.params import count_params
    from repro_torch.steps import init_model

    n_steps = DECODE_STEPS
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = get_config(arch, attention_impl="pallas")
    window, n = cfg.long_window, cfg.n_layers
    max_len = prompt + n_steps
    defs, params = init_model(cfg, seed=0, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    toks = torch.randint(1, cfg.vocab, (b, prompt), generator=g, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    # K2's lengths, recorded at its launcher (behind the wrapper, which counts)
    launch, lengths = ops.decode_attention_bmhd, []

    def recording(q, ck, cv, lens):
        lengths.append(lens)
        return launch(q, ck, cv, lens)

    ops.reset_launches()
    t0 = time.perf_counter()
    logits, cache = DEC.prefill(params, cfg, {"tokens": toks}, max_len=max_len, window=window)
    nxt = logits.argmax(-1)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    after_prefill = ops.launches()
    finite = torch.isfinite(logits).all()
    out_toks = []
    ops.decode_attention_bmhd = recording
    try:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            logits, cache = DEC.decode_step(params, cfg, cache, nxt, window=window)
            nxt = logits.argmax(-1)
            finite &= torch.isfinite(logits).all()
            out_toks.append(nxt)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3
    finally:
        ops.decode_attention_bmhd = launch
    launches = ops.launches()
    out_toks = torch.cat(out_toks, dim=1)
    want = dict(expected_launches(cfg, 1, 0), flash_attention=0)
    if after_prefill != want:
        raise AssertionError(f"window {arch}: prefill launches {after_prefill}, want {want}")
    want = dict(expected_launches(cfg, 1, n_steps), flash_attention=0)
    if launches != want:
        raise AssertionError(f"window {arch}: launches {launches}, want {want}")
    lens = torch.stack(lengths).cpu()
    if tuple(lens.shape) != (n * n_steps, b) or not bool((lens == window).all()):
        raise AssertionError(f"window {arch}: K2 lengths {lens.unique().tolist()} in "
                             f"{tuple(lens.shape)} calls x rows, want all {window}")
    if tuple(cache["k"].shape) != (n, b, window, cfg.n_kv_heads, cfg.resolved_head_dim):
        raise AssertionError(f"window {arch}: cache K {tuple(cache['k'].shape)}")
    if not bool(finite) or not bool(((out_toks >= 0) & (out_toks < cfg.vocab)).all()):
        raise AssertionError(f"window {arch}: logits finite {bool(finite)}, tokens "
                             f"in [{int(out_toks.min())}, {int(out_toks.max())}]")
    if cache["pos"].tolist() != [prompt + n_steps] * b:
        raise AssertionError(f"window {arch}: pos {cache['pos'].tolist()} after {n_steps} steps")
    peak = torch.cuda.max_memory_allocated()
    kv = cache["k"].numel() * cache["k"].element_size() * 2
    out = {"launches": launches, "prefill_ms": prefill_ms, "step_ms": decode_ms / n_steps,
           "tokens_per_s": b * n_steps / (decode_ms / 1e3), "peak_bytes": peak}
    log("window", f"{arch} {cfg.dtype} full width and depth ({count_params(defs) / 1e9:.3f}B "
        f"params, {n} layers), window {window}: B={b}, {prompt}-token prompts (S % {window} = "
        f"{prompt % window}: the first step evicts position {prompt - window + prompt % window}, "
        f"as the reference does, not the oldest, {prompt - window}); circular K/V cache of "
        f"{cache['k'].shape[2]} slots ({kv / 1e9:.3f} GB); init {init_s:.1f}s")
    log("window", f"{arch}: windowed prefill {prefill_ms:.2f} ms, {n_steps} greedy decode steps "
        f"{decode_ms:.2f} ms = {out['step_ms']:.2f} ms a step, {out['tokens_per_s']:.1f} "
        f"tokens/s; peak memory {peak / 2**30:.2f} GiB ({peak} bytes); {b} x {n_steps} finite "
        f"tokens, first row {out_toks[0, :8].tolist()}...")
    log("window", f"{arch} launches: {after_prefill} after the prefill (no K1 with a window), "
        f"{launches} after the steps (= {n} K2 a step), every K2 call at lengths {window}")
    with torch.no_grad():
        prof = {"prefill": _profile(f"{arch} windowed prefill (B={b}, S={prompt})",
                                    lambda: DEC.prefill(params, cfg, {"tokens": toks},
                                                        max_len=max_len, window=window)),
                "decode": _profile(f"{arch} windowed decode step ({b} rows, {window} slots)",
                                   lambda: DEC.decode_step(params, cfg, cache, nxt,
                                                           window=window))}
    out["busy_ms"] = {k: v[0] for k, v in prof.items()}
    out["wall_ms"] = {k: v[1] for k, v in prof.items()}
    del params, cache, logits
    torch.cuda.empty_cache()
    return out


def _jittered(x):
    """x (a CPU tensor) with every element moved one f32 step up or down, the
    direction drawn from a fixed seed: the rounding-level change an f32
    product with another summation order makes everywhere."""
    import torch

    up = torch.rand(x.shape, generator=torch.Generator().manual_seed(0)) < 0.5
    return torch.nextafter(x, torch.where(up, float("inf"), float("-inf")).to(x.dtype))


@contextlib.contextmanager
def f32_cumsum():
    """``torch.cumsum`` accumulating in f32, one step after another, while it
    is open (restored on exit).  The CPU's cumsum of f32 accumulates in f64
    (its accumulation type) and the card's in f32, whose error grows with
    the running sum: over 256 steps of the mLSTM's log forget gates (down to
    ~-100) that moves an mLSTM layer's output by ~1e-4 of its max under the
    reference's init.  The xlstm controls take it on."""
    import torch

    cumsum = torch.cumsum

    def sequential(x, dim):
        acc, out = torch.zeros_like(x.select(dim, 0)), []
        for t in x.unbind(dim):
            acc = acc + t
            out.append(acc)
        return torch.stack(out, dim)

    torch.cumsum = sequential
    try:
        yield
    finally:
        torch.cumsum = cumsum


def _nudged_xlstm(params: dict) -> dict:
    """``_nudged`` for the xlstm family's list of blocks: block 0's norm scale
    moved one f32 step up."""
    import torch

    first = params["blocks"][0]
    scale = first["norm"]["scale"].clone()
    scale[0] = torch.nextafter(scale[0], torch.full_like(scale[0], float("inf")))
    first = {**first, "norm": {**first["norm"], "scale": scale}}
    return {**params, "blocks": [first] + params["blocks"][1:]}


def phase_xlstm_parity() -> None:
    """xlstm-125m at full width and depth in f32 (TF32 off, phase 1): the
    card against the CPU on the same params and tokens.  The family has no
    kernel route (the reference's xlstm reaches no Pallas call), so this is
    the check that the card computes what the CPU computes.  Every layer on
    the same input (the CPU's stream) and the chain (prefill of B x S tokens,
    then decode steps, through the entry points) are held to CHAOS_FACTOR
    times a control: the CPU route with its input perturbed at f32
    rounding (every element of the layer's input one f32 step up or down,
    ``_jittered``, for a layer; block 0's norm scale one step up,
    ``_nudged_xlstm``, for the chain, as phase 4 does) and its cumsum
    accumulated in f32 as the card's is (``f32_cumsum``).  Under the
    reference's init an mLSTM layer amplifies an f32 rounding within itself
    (its normaliser max(|sum_j w|, exp(-m)) divides by a sum that cancels),
    so a layer is held to its control, as depth is.  No kernel may
    launch."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import decoding as DEC
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as TF
    from repro_torch.models import xlstm as XL
    from repro_torch.models.params import count_params, tree_map
    from repro_torch.steps import init_model

    arch, b, s, n_dec = XLSTM_PARITY
    cfg = get_config(arch, dtype="float32")
    t0 = time.perf_counter()
    defs, params = init_model(cfg, seed=0, device="cuda")
    cpu = tree_map(lambda t: t.cpu(), params)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(1, cfg.vocab, (b, s), generator=g)
    steps = torch.randint(1, cfg.vocab, (n_dec, b, 1), generator=g)

    def chain(prm, dev):
        out, cache = DEC.prefill(prm, cfg, {"tokens": toks.to(dev)}, max_len=s + n_dec)
        got = [out.cpu()]
        for tok in steps:
            out, cache = DEC.decode_step(prm, cfg, cache, tok.to(dev))
            got.append(out.cpu())
        return got, cache

    def block(kind, p, x):
        if kind == "mlstm":
            return x + XL.mlstm_forward(p, x, cfg)[0]
        return XL.slstm_forward(p, x, cfg)[0]

    ops.reset_launches()
    with torch.no_grad():
        card, card_cache = chain(params, "cuda")
        want, cpu_cache = chain(cpu, "cpu")
        with f32_cumsum():
            control, _ = chain(_nudged_xlstm(cpu), "cpu")
        # every layer on the same input: the CPU's stream
        x = L.embed_tokens(cpu["embed"], toks, cfg)
        layers = []
        for li, (kind, pc, pg) in enumerate(zip(TF.xlstm_layer_kinds(cfg), cpu["blocks"],
                                                params["blocks"])):
            got = block(kind, pg, x.cuda()).cpu()
            with f32_cumsum():
                ctl = block(kind, pc, _jittered(x))
            x = block(kind, pc, x)
            dk, dc = _rel(got, x), _rel(ctl, x)
            if dk > max(CHAOS_FACTOR * dc, PARITY_REL_TOL):
                raise AssertionError(f"xlstm {arch} layer {li} ({kind}), same input: card "
                                     f"err {dk:.3e}, more than {CHAOS_FACTOR} x the control's "
                                     f"{dc:.3e}")
            layers.append((dk, dc))
    if any(ops.launches().values()):
        raise AssertionError(f"xlstm parity launched kernels: {ops.launches()}")
    dk = max(_rel(c, w) for c, w in zip(card, want))
    dc = max(_rel(c, w) for c, w in zip(control, want))
    if dk > max(CHAOS_FACTOR * dc, PARITY_REL_TOL):
        raise AssertionError(f"xlstm {arch}: card drifts {dk:.3e} from the CPU, more than "
                             f"{CHAOS_FACTOR} x the control's {dc:.3e}")
    state = max((_rel(c.cpu(), w), f"layer {i} {key}")
                for i, (cb, wb) in enumerate(zip(card_cache["blocks"], cpu_cache["blocks"]))
                for key, c in cb.items() for w in (wb[key],))
    worst = max(range(len(layers)), key=lambda i: layers[i][0])
    log("parity", f"{arch} f32 ({count_params(defs) / 1e9:.3f}B params, {cfg.n_layers} layers: "
        f"{TF.xlstm_layer_kinds(cfg).count('slstm')} sLSTM), B={b} S={s} + {n_dec} decode "
        f"steps, card against CPU ({time.perf_counter() - t0:.1f}s): no kernel launched")
    log("parity", f"{arch} same input, layer by layer: worst layer {worst} ("
        f"{TF.xlstm_layer_kinds(cfg)[worst]}) err / max |x| {layers[worst][0]:.3e} (control "
        f"{layers[worst][1]:.3e}); each layer within {CHAOS_FACTOR} x its control, ok; card / "
        "control by layer: " + ", ".join(f"{dk:.1e}/{dc:.1e}" for dk, dc in layers))
    log("parity", f"{arch} chain through the entry points: logits drift (max err / max |logit|) "
        f"card {dk:.3e}, control (CPU, input nudged one f32 step, f32 cumsum) {dc:.3e}, within "
        f"{CHAOS_FACTOR} x, ok; worst state leaf after the steps {state[0]:.3e} ({state[1]})")
    del params, cpu, card_cache
    torch.cuda.empty_cache()


def sfu_exp_rate() -> float:
    """exps per second the card's SFUs give at its max SM clock
    (``nvidia-smi --query-gpu=clocks.max.sm``), all SMs busy."""
    import torch

    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True)
    mhz = float(out.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rate = sms * SFU_EXP_PER_CLOCK * mhz * 1e6
    log("timing", f"max SM clock {mhz:.0f} MHz (nvidia-smi clocks.max.sm), {sms} SMs: "
        f"{rate / 1e12:.3f} T exp/s on the SFUs ({SFU_EXP_PER_CLOCK} a clock an SM)")
    return rate


def smi_state() -> str:
    """The card's SM and memory clocks, power draw and performance state now."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,pstate",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
                         check=True)
    return out.stdout.strip().splitlines()[0]


def phase_fresh() -> dict:
    """Device time of each kernel at its main path's serve shape (the main
    rows of phase 6) in this fresh process, before any other phase loads the
    card, and before the profiler starts to lose device records (see
    device_ms); then K3's again after 3 s of f32 matmuls.  Phase 6 times
    the same calls after minutes of parity and serving."""
    import torch

    from repro_torch.kernels import ops, ref

    q, k, v = _flash_inputs(1, 512, 8, 1, 256, torch.bfloat16, seed=7)
    qd, ckd, cvd, lens = _decode_inputs(8, 1024, 8, 1, 256, torch.bfloat16, 8, [528] * 8)
    delta, B, C, x, A = _scan_inputs(1, 512, 3200, 16, seed=9)
    dA, dBx = ref.ssm_discretize(delta, B, x, A)
    fns = {"flash_attention": lambda: ops.flash_attention(q, k, v),
           "decode_attention": lambda: ops.decode_attention(qd, ckd, cvd, lens),
           "ssm_scan": lambda: ops.ssm_scan(dA, dBx, C),
           "ssm_scan_fused": lambda: ops.ssm_scan_fused(delta, B, C, x, A)}
    before = smi_state()
    fresh = {name: device_ms(fn) for name, fn in fns.items()}
    log("fresh", f"device time in a fresh process (nvidia-smi clocks.sm, clocks.mem, power.draw, "
        f"pstate: {before}): " + "; ".join(f"{name} {ms * 1e3:.2f} us"
                                           for name, ms in fresh.items())
        + f"; ssm_scan_fused from CUDA events behind a queued sleep "
        f"{queued_ms(fns['ssm_scan_fused']) * 1e3:.2f} us")
    m = torch.randn(8192, 8192, device="cuda")
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 3:
        torch.mm(m, m)
        torch.cuda.synchronize()
    loaded = smi_state()
    after = device_ms(fns["ssm_scan_fused"])
    log("fresh", f"ssm_scan_fused after 3 s of f32 matmuls ({loaded}): {after * 1e3:.2f} us, "
        f"from CUDA events behind a queued sleep {queued_ms(fns['ssm_scan_fused']) * 1e3:.2f} us")
    del m
    torch.cuda.empty_cache()
    return {"fresh_ms": fresh, "ssm_scan_fused_after_load_ms": after}


def phase_timing(worst: dict, serves: dict, fresh: dict) -> list:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    def measure(fns):  # timed at once: the callables close over this block's tensors
        t0 = time.perf_counter()
        dev = {key: device_ms(fn, **PLAIN_REPEATS["dev"] if key == "plain_ms" else {})
               for key, fn in fns.items()}
        events = queued_ms(fns["ms"])
        for _ in range(2):
            if dev["ms"] >= SHORT_READ * events:
                break
            log("timing", f"the profiler read {dev['ms'] * 1e3:.2f} us, under {SHORT_READ} x "
                f"the CUDA events' {events * 1e3:.2f} us: profiled again")
            dev["ms"] = device_ms(fns["ms"])
        return {"dev": dev,
                "call": {key: call_ms(fn, **PLAIN_REPEATS["call"] if key == "plain_ms" else {})
                         for key, fn in fns.items()},
                "events_ms": events, "took_s": time.perf_counter() - t0}

    log("timing", f"nvidia-smi clocks.sm, clocks.mem, power.draw, pstate: {smi_state()}")

    bf16 = torch.bfloat16
    item = 2  # bytes per bf16 element
    rows = []

    def flash_row(b, s, hq, hkv, d, where):
        # bytes and FLOPs: ops.kernel_cost (q, k, v read once and out written
        # once; q.k and p.v over the causal pairs, 2 * D each)
        q, k, v = _flash_inputs(b, s, hq, hkv, d, bf16, seed=7)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        flops, nbytes = ops.kernel_cost("flash_attention", q, k, v)
        return dict(
            name="flash_attention", where=where,
            **measure({"ms": lambda: ops.flash_attention(q, k, v),
                       "plain_ms": lambda: flash_plain(q, k, v),
                       "library_ms": lambda: F.scaled_dot_product_attention(
                           qt, kt, vt, is_causal=True, enable_gqa=True)}),
            nbytes=nbytes, flops=flops, peak=BF16_FLOPS,
            shape=f"B={b} S={s} Hq={hq} Hkv={hkv} D={d} bf16")

    def decode_row(b, m, length, hq, hkv, d, where):
        # bytes: q once, the valid K/V slots once, lengths, out; FLOPs: 4 * D
        # per (query head, valid slot).  Not ops.kernel_cost, which charges
        # the whole cache of m slots: the valid length is known here
        q, ck, cv, lens = _decode_inputs(b, m, hq, hkv, d, bf16, 8, [length] * b)
        qt = q.transpose(1, 2).contiguous()
        kt, vt = ck.transpose(1, 2).contiguous(), cv.transpose(1, 2).contiguous()
        mask = (torch.arange(m, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
        return dict(
            name="decode_attention", where=where,
            **measure({"ms": lambda: ops.decode_attention(q, ck, cv, lens),
                       "plain_ms": lambda: decode_plain(q, ck, cv, lens),
                       "library_ms": lambda: F.scaled_dot_product_attention(
                           qt, kt, vt, attn_mask=mask, enable_gqa=True)}),
            nbytes=item * (2 * b * hq * d + 2 * b * length * hkv * d) + 4 * b,
            flops=4 * b * hq * length * d, peak=BF16_FLOPS,
            shape=f"B={b} M={m} len={length} Hq={hq} Hkv={hkv} D={d} bf16")

    # K1 at the serve prefill (one request of 512 tokens); K2 at the serve
    # decode tick (8 slots, cache of 1024, valid lengths 512..543 over the
    # run, timed at their mean, 528): gemma's heads, then hymba's
    rows.append(flash_row(1, 512, 8, 1, 256, "gemma-2b"))
    rows.append(decode_row(8, 1024, 528, 8, 1, 256, "gemma-2b"))
    rows.append(flash_row(1, 512, 25, 5, 64, "hymba-1.5b"))
    rows.append(decode_row(8, 1024, 528, 25, 5, 64, "hymba-1.5b"))
    # the window decode phase's step: B=2, a circular cache of 1024 slots,
    # every slot valid after the wrap
    rows.append(decode_row(2, 1024, 1024, 25, 5, 64, "hymba-1.5b window"))
    # the same at the head dims no earlier path ran: phi3-mini's (32/32,
    # D=96) and nemotron-4's (96/8, D=192), at the same serve shapes
    rows.append(flash_row(1, 512, 32, 32, 96, "phi3-mini-3.8b"))
    rows.append(decode_row(8, 1024, 528, 32, 32, 96, "phi3-mini-3.8b"))
    rows.append(flash_row(1, 512, 96, 8, 192, "nemotron-4-340b"))
    rows.append(decode_row(8, 1024, 528, 96, 8, 192, "nemotron-4-340b"))
    # granite-moe's serve shapes (24/8, D=64)
    rows.append(flash_row(1, 512, 24, 8, 64, "granite-moe-3b-a800m"))
    rows.append(decode_row(8, 1024, 528, 24, 8, 64, "granite-moe-3b-a800m"))
    # the decode phase's shapes: the B=8 prefill, and a step at the mean
    # valid length over its 32 steps (prompt + 16): phi-3-vision (32/32,
    # D=96, S = 1088, cache 1152) and whisper's decoder (20/20, D=64, 192
    # tokens, cache 448)
    rows.append(flash_row(8, 1088, 32, 32, 96, "phi-3-vision-4.2b"))
    rows.append(decode_row(8, 1152, 1104, 32, 32, 96, "phi-3-vision-4.2b"))
    rows.append(flash_row(8, 192, 20, 20, 64, "whisper-large-v3"))
    rows.append(decode_row(8, 448, 208, 20, 20, 64, "whisper-large-v3"))

    # the fixed cost of a call, beside the serve shapes: K1 with one 64-row
    # tile per head, K2 with one valid slot a row, and a one-element fill
    # (the least a device op takes in this measurement)
    q1, k1, v1 = _flash_inputs(1, 64, 8, 1, 256, bf16, seed=7)
    qd, ckd, cvd, lensd = _decode_inputs(8, 1024, 8, 1, 256, bf16, 8, [1] * 8)
    one = torch.empty(1, device="cuda")
    probe = {"flash_attention B=1 S=64 Hq=8 Hkv=1 D=256": lambda: ops.flash_attention(q1, k1, v1),
             "decode_attention B=8 M=1024 len=1 Hq=8 Hkv=1 D=256":
                 lambda: ops.decode_attention(qd, ckd, cvd, lensd),
             "fill of one f32 element": lambda: one.zero_()}
    log("timing", "fixed cost, device time: " + "; ".join(
        f"{what} {device_ms(fn) * 1e3:.2f} us" for what, fn in probe.items()))

    # K4 and K3 at hymba's serve prefill: one request of 512 tokens, di=3200, N=16, f32
    b, s, di, n = 1, 512, 3200, 16
    delta, B, C, x, A = _scan_inputs(b, s, di, n, seed=9)
    dA, dBx = ref.ssm_discretize(delta, B, x, A)
    shape = f"B={b} S={s} di={di} N={n} f32"
    # bytes and FLOPs: ops.kernel_cost.  K4: dA, dBx, C read once, y and
    # h_last written once; the h update (2), h * C (1) and its sum over N
    # (1) per (b, t, d, n)
    flops, nbytes = ops.kernel_cost("ssm_scan", dA, dBx, C)
    rows.append(dict(
        name="ssm_scan", where="hymba-1.5b",
        **measure({"ms": lambda: ops.ssm_scan(dA, dBx, C),
                   "plain_ms": lambda: ref.ssm_scan_ref(dA, dBx, C)}),
        nbytes=nbytes, flops=flops, peak=F32_FLOPS, shape=shape))
    # K3: delta, x, B, C, A read once, y and h_last written once; K4's 4
    # FLOPs plus delta * A and delta * B * x (2) per element; and one exp
    # per element, on the SFU (its own operation type)
    flops, nbytes = ops.kernel_cost("ssm_scan_fused", delta, B, C, x, A)
    rows.append(dict(
        name="ssm_scan_fused", where="hymba-1.5b",
        **measure({"ms": lambda: ops.ssm_scan_fused(delta, B, C, x, A),
                   "plain_ms": lambda: fused_plain(delta, B, C, x, A)}),
        nbytes=nbytes, flops=flops, peak=F32_FLOPS, exps=b * s * di * n, shape=shape))

    log("timing", f"profiler: {PROFILER['short']} of {PROFILER['sessions']} sessions so far lost "
        f"device records, {PROFILER['lost']} in all; each op is timed by its mean over the "
        "records kept")
    exp_rate = sfu_exp_rate()
    out = {}
    for r in rows:
        dev, call = r["dev"], r["call"]
        bound = _bound(r["flops"], r["nbytes"], r["peak"], exp_rate, r.get("exps", 0))
        bound_ms, bound_by = bound["bound_ms"], bound["bound_by"]
        t_bytes, t_flops, t_exps = bound["bytes_ms"], bound["flops_ms"], bound["exps_ms"]
        lib = dev.get("library_ms")
        grids = ops.GRIDS_PER_CALL[r["name"]]
        of_lib = dev["ms"] / lib if lib is not None else None
        by_path = {label: sv["launches"][r["name"]] for label, sv in serves.items()}
        log("timing", f"{r['name']} at {r['where']}'s {r['shape']}: device time kernel "
            f"{dev['ms'] * 1e3:.2f} us, plain {dev['plain_ms'] * 1e3:.2f} us, library "
            + (f"(sdpa) {lib * 1e3:.2f} us" if lib is not None else "none")
            + f"; per call, host included: kernel {call['ms'] * 1e3:.2f} us, plain "
            f"{call['plain_ms'] * 1e3:.2f} us"
            + (f", library {call['library_ms'] * 1e3:.2f} us" if lib is not None else "")
            + f"; bound {bound_ms * 1e3:.3f} us ({bound_by}: {r['nbytes']:.0f} B = "
            f"{t_bytes * 1e3:.3f} us, {r['flops']:.4g} FLOP = {t_flops * 1e3:.3f} us"
            + (f", {r['exps']:.4g} exp = {t_exps * 1e3:.3f} us" if r.get("exps") else "")
            + "); kernel / library "
            + (f"{of_lib:.3f}" if of_lib is not None else "none")
            + f", bound / kernel {bound_ms / dev['ms']:.4f}; kernel from CUDA events behind a "
            f"queued sleep {r['events_ms'] * 1e3:.2f} us; wrapper calls on the serve paths "
            f"{by_path}, {grids} grid(s) each; measured in {r['took_s']:.1f}s")
        entry = {"ms": dev["ms"], "plain_ms": dev["plain_ms"], "bound_ms": bound_ms,
                 "bound_by": bound_by, "library_ms": lib, "ms_over_library": of_lib,
                 "bound_over_ms": bound_ms / dev["ms"], "call_ms": call["ms"],
                 "events_ms": r["events_ms"], "shape": r["shape"]}
        if r["name"] in out:  # a second shape of the same kernel
            out[r["name"]]["at_" + r["where"]] = entry
            continue
        main = MAIN_PATH[r["name"]]
        # launches: wrapper calls on the main path; grids_per_call: the
        # __global__ kernels each call launches
        out[r["name"]] = {"name": r["name"], "route": "cuda",
                          "source": f"src/repro_torch/kernels/csrc/{SOURCES[r['name']]}",
                          "replaces": REPLACES[r["name"]],
                          "launches": serves[main]["launches"][r["name"]],
                          "main_path": main, "launches_by_path": by_path,
                          "grids_per_call": grids,
                          "max_abs_err": worst[r["name"]], **entry,
                          "fresh_ms": fresh["fresh_ms"][r["name"]]}
        if r["name"] == "ssm_scan_fused":
            out[r["name"]]["after_load_ms"] = fresh["ssm_scan_fused_after_load_ms"]
    return list(out.values())


def _profile(what: str, fn, ranges: tuple = ()) -> tuple:
    """Wall time, device busy time and the top device ops of one fn().  A
    profiling session that saw no device time is repeated (fn runs again),
    up to three sessions in all.  ``ranges`` names ``record_function``
    ranges open during fn (see ``moe_ranges``): each one's device time, the
    kernels launched inside it, is logged with its share of busy.  Returns
    (busy ms, wall ms, {range: device ms, None where not measured})."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    attempts = 3
    for attempt in range(1, attempts + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # a range also shows on the device's timeline as an annotation: not an op
        averages = prof.key_averages()  # aggregated once: it walks every event
        events = [e for e in averages if e.device_type.name == "CUDA" and e.key not in ranges]
        busy_us = sum(e.self_device_time_total for e in events)
        if busy_us > 0:
            break
        log("breakdown", f"{what}: profiling session {attempt} of {attempts} saw no device time")
    else:
        raise RuntimeError(f"{what} {wall * 1e3:.2f} ms wall: the profiler saw no device time "
                           f"in {attempts} sessions")
    n_kernels = sum(e.count for e in events)
    log("breakdown", f"{what} {wall * 1e3:.2f} ms wall, device busy {busy_us / 1e3:.2f} ms "
        f"(idle share {1 - busy_us / 1e3 / (wall * 1e3):.3f}), {n_kernels} device ops")
    ranked = sorted(events, key=lambda e: -e.self_device_time_total)
    # the top six, and the port's own kernels wherever they rank
    for i, e in enumerate(ranked):
        if i < 6 or "repro_torch" in e.key:
            log("breakdown", f"  {e.self_device_time_total / 1e3:.3f} ms "
                f"({100 * e.self_device_time_total / busy_us:.1f}% of busy, rank {i + 1}) "
                f"x{e.count} {e.key[:90]}")
    spans = {e.key: e for e in averages if e.key in ranges and e.device_type.name == "CPU"}
    range_ms = {}
    for name in ranges:
        e = spans.get(name)
        range_ms[name] = None
        if e is None or e.device_time_total <= 0:
            log("breakdown", f"  range {name}: device time not measured (no kernels attributed)")
            continue
        range_ms[name] = e.device_time_total / 1e3
        log("breakdown", f"  range {name}: {e.device_time_total / 1e3:.3f} ms of kernels "
            f"({100 * e.device_time_total / busy_us:.1f}% of busy) in {e.count} calls")
    return busy_us / 1e3, wall * 1e3, range_ms


# the moe layer's functions timed as ranges in phase 7: the whole layer, and
# inside it the router (f32 logits, softmax, top-k) and the expert FFNs; the
# rest of the layer is the capacity dispatch and the combine
MOE_RANGES = {"apply_moe": "moe layer", "_router": "moe router", "_expert_ffn": "moe expert FFNs"}


@contextlib.contextmanager
def moe_ranges():
    """``repro_torch.models.moe``'s functions of MOE_RANGES, each run inside a
    ``record_function`` range of its label; restored on exit."""
    from torch.profiler import record_function

    from repro_torch.models import moe as MOE

    saved = {fn: getattr(MOE, fn) for fn in MOE_RANGES}

    def ranged(fn, label):
        def call(*args):
            with record_function(label):
                return fn(*args)
        return call

    for fn, label in MOE_RANGES.items():
        setattr(MOE, fn, ranged(saved[fn], label))
    try:
        yield tuple(MOE_RANGES.values())
    finally:
        for fn, f in saved.items():
            setattr(MOE, fn, f)


def moe_serve_bounds(cfg, defs, prompt: int, slots: int, length: int) -> dict:
    """Least device time (ms) of a moe model's prefill of one ``prompt``
    and of a decode tick of ``slots`` rows at valid length ``length``: the
    larger of bytes over HBM_BYTES_PER_S and FLOPs over BF16_FLOPS.  Bytes:
    every weight read once (not the embedding table, of which a step reads
    a few rows), the K/V written (prefill) or read (decode).  FLOPs: the
    attention projections, q.k and p.v, the expert FFNs on every slot of the
    capacity dispatch (each expert runs all its slots, filled or not), the
    shared experts, the router, and the unembedding of the tokens whose
    logits the step returns."""
    from repro_torch.models import moe as MOE
    from repro_torch.models.layers import adtype
    from repro_torch.models.params import param_bytes

    m, d, n = cfg.moe, cfg.d_model, cfg.n_layers
    item = adtype(cfg).itemsize
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    mats = 3 if cfg.activation in ("swiglu", "geglu") else 2
    row_ffn = 2 * mats * d * m.d_ff_expert  # FLOPs of one expert on one row
    kv = 2 * item * n * hkv * hd  # K and V of one position, every layer

    def bound(rows, expert_slots, pairs, out_rows, kv_bytes):
        flops = n * (2 * rows * d * (2 * hq + 2 * hkv) * hd + 4 * hq * hd * pairs
                     + row_ffn * (m.e_pad * expert_slots + m.n_shared_experts * rows)
                     + 2 * rows * d * m.n_experts) + 2 * out_rows * d * cfg.vocab
        nbytes = param_bytes(defs) - cfg.vocab * d * item + kv_bytes
        t_b, t_f = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
        return {"bytes": nbytes, "flops": flops, "bytes_ms": t_b, "flops_ms": t_f,
                "ms": max(t_b, t_f), "by": "bytes" if t_b >= t_f else "operations"}

    return {"prefill": bound(prompt, MOE.capacity(prompt, m), prompt * (prompt + 1) / 2, 1,
                             kv * prompt),
            "decode": bound(slots, slots * MOE.capacity(1, m), slots * length, slots,
                            kv * slots * length),
            "expert_bytes": n * m.e_pad * mats * d * m.d_ff_expert * item}


def phase_breakdown(arch: str) -> None:
    """One prefill and one full decode tick of the bf16 serve engine, with the
    device's busy time from the profiler against the host's wall time.  For
    the moe family, also the device time of its MoE layers, router and
    expert FFNs (``moe_ranges``), and each step's bound (``moe_serve_bounds``)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import decoding as DEC
    from repro_torch.serving import ServingEngine
    from repro_torch.steps import init_model

    t0 = time.perf_counter()
    cfg = get_config(arch, attention_impl="pallas")
    defs, params = init_model(cfg, seed=0, max_seq=1024, device="cuda")
    eng = ServingEngine(cfg, params, max_batch=8, max_len=1024, prefill_len=512, device="cuda")
    g = torch.Generator().manual_seed(0)
    for _ in range(8):
        eng.submit(torch.randint(1, cfg.vocab, (512,), generator=g).tolist(), max_new_tokens=64)
    eng.step()  # admit all 8 + first tick, warms everything up
    for _ in range(2):
        eng.step()
    moe = cfg.family == "moe"
    with torch.no_grad(), (moe_ranges() if moe else contextlib.nullcontext(())) as ranges:
        toks = torch.randint(1, cfg.vocab, (1, 512), generator=g).to("cuda")
        prof = {"prefill": _profile(f"{arch} prefill (1 x 512 tokens)",
                                    lambda: DEC.prefill(params, cfg, {"tokens": toks},
                                                        max_len=1024), ranges),
                "decode": _profile(f"{arch} decode tick (8 slots)", eng.step, ranges)}
    busy = {step: p[0] for step, p in prof.items()}
    if moe:  # the slots' valid length in the profiled tick: 515 (prompts of 512, 3 ticks)
        length = int(eng.cache["pos"].float().mean())
        bounds = moe_serve_bounds(cfg, defs, 512, 8, length)
        for step, bd in ((k, bounds[k]) for k in ("prefill", "decode")):
            spans = prof[step][2]
            if None not in spans.values():
                rest = spans["moe layer"] - spans["moe router"] - spans["moe expert FFNs"]
                log("breakdown", f"{arch} {step}: MoE dispatch and combine (the layer but its "
                    f"router and expert FFNs) {rest:.3f} ms, "
                    f"{100 * rest / busy[step]:.1f}% of busy")
            log("breakdown", f"{arch} {step} bound {bd['ms']:.3f} ms ({bd['by']}: "
                f"{bd['bytes'] / 1e9:.3f} GB = {bd['bytes_ms']:.3f} ms, {bd['flops'] / 1e12:.4f} "
                f"TFLOP = {bd['flops_ms']:.3f} ms; the expert weights alone "
                f"{bounds['expert_bytes'] / 1e9:.3f} GB); device busy / bound "
                f"{busy[step] / bd['ms']:.2f}")
    del eng, params
    torch.cuda.empty_cache()
    log("breakdown", f"{arch} took {time.perf_counter() - t0:.1f}s")


def train_full(arch: str, b: int, s: int, steps: int, remat: bool = False,
               scan_impl=None, part: str = "a") -> dict:
    """(a) a full-width bf16 run through the train loop; no kernel may
    launch (the hybrid block trains through its differentiable scans)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train as T
    from repro_torch.models.params import count_params, tree_leaves, tree_paths
    from repro_torch.models.transformer import model_defs
    from repro_torch.steps import init_model

    cfg = get_config(arch)
    if scan_impl is not None:
        cfg = with_scan(cfg, scan_impl)
    before = ops.launches()
    # step 0's params, drawn as train() draws them (same seed, same device)
    init = [t.cpu() for t in tree_leaves(init_model(cfg, seed=0, device="cuda")[1])]
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    history, stamps = [], []

    def on_step(step, params, m):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        history.append(m)
        if step == 0:  # every leaf must have moved: a missing grad would leave one
            for (path, p), q in zip(tree_paths(params), init):
                if torch.equal(p.detach().cpu(), q):
                    raise AssertionError(f"train: {path} did not move in step 1")
            stamps[-1] = time.perf_counter()  # the check is not a step

    t0 = time.perf_counter()
    result = T.train(cfg, steps, b, s, remat=remat, on_step=on_step, device="cuda")
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if ops.launches() != before:
        raise AssertionError(f"train {arch}: kernels launched {before} -> {ops.launches()}")
    for i, m in enumerate(history):
        if not all(map(math.isfinite, m.values())) or m["grad_norm"] <= 0:
            raise AssertionError(f"train {arch}: step {i + 1} metrics {m}")
    if result["state"] != "done" or len(history) != steps:
        raise AssertionError(f"train {arch}: {result}")
    ms = (stamps[-1] - stamps[0]) / (steps - 1) * 1e3
    n = count_params(model_defs(cfg))
    flops = 6 * n * b * s  # forward and backward of every param, per token
    adam_bytes = 22 * n  # bf16 p and g, f32 mu and nu: read p g mu nu, write p mu nu
    bound_ms = (flops / BF16_FLOPS + adam_bytes / HBM_BYTES_PER_S) * 1e3
    losses = [round(m["loss"], 4) for m in history]
    gnorms = [round(m["grad_norm"], 4) for m in history]
    what = f"{arch}" + (f" ({scan_impl} scan)" if scan_impl else "")
    log("train", f"{part}. {what} full width {cfg.dtype} ({n} params), B={b} S={s}, {steps} "
        f"steps, {'remat' if remat else 'no remat'}: losses {losses}, grad norms {gnorms}; "
        f"every param leaf moved in step 1; no kernel launched")
    log("train", f"{part}. {what} {ms:.2f} ms/step over steps 2-{steps} = "
        f"{b * s / ms * 1e3:.0f} tokens/s; "
        f"peak memory {peak / 2**30:.2f} GiB ({peak} bytes); bound {bound_ms:.2f} ms "
        f"({flops / 1e12:.2f} TFLOP at {BF16_FLOPS / 1e12:.0f} TFLOP/s bf16 + AdamW "
        f"{adam_bytes / 1e9:.2f} GB at {HBM_BYTES_PER_S / 1e12:.2f} TB/s), share "
        f"{bound_ms / ms:.3f}; {wall:.1f} s in all with init")
    torch.cuda.empty_cache()
    return {"ms_per_step": ms, "tokens_per_s": b * s / ms * 1e3, "peak_bytes": peak,
            "bound_ms": bound_ms, "share": bound_ms / ms, "losses": losses}


def _drift(got, want) -> float:
    """max |got - want| / max |want| over one leaf (CPU tensors)."""
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def _tame(params: dict, cfg) -> dict:
    """``params`` with wq and wk rescaled (in place) to std 1/sqrt(d_model),
    so the attention scores are O(1).  The reference draws wk at std 1 (its
    fan-in is n_kv_heads): its scores run in the hundreds, the softmax
    backward of those near one-hot rows cancels, and a change of the input
    at f32 rounding moves the 2-layer grads by percents."""
    import torch

    attn = params["blocks"]["attn"]
    with torch.no_grad():
        attn["wq"].mul_(math.sqrt(cfg.n_heads / cfg.d_model))
        attn["wk"].mul_(math.sqrt(cfg.n_kv_heads / cfg.d_model))
    return params


def _parity_faults(run: dict, cpu: dict, lr: float, mu_eps: float) -> tuple:
    """(faults, worst) of one step's ``run`` against the CPU's: loss and grad
    norm within TRAIN_REL_TOL relative; each moment leaf and new-param leaf
    within TRAIN_LEAF_TOL of its max |x|.  A new param may miss that only
    where Adam's first step turns on the grad's last digits: clipped grads
    of the order of eps, where g / (|g| + eps) is not fixed by f32.  That is
    where the CPU's first moment is within TRAIN_LEAF_TOL of its leaf's max,
    or at most ``mu_eps`` = (1 - b1) eps, the first moment of a grad of eps
    (which matters in a leaf whose largest grad is under eps /
    TRAIN_LEAF_TOL).  There it may miss by at most 2 lr, and in fewer than
    0.1% of the params.  ``worst`` maps each quantity to (drift, leaf)."""
    faults, worst = [], {}
    for k in ("loss", "grad_norm"):
        rel = abs(run["m"][k] - cpu["m"][k]) / abs(cpu["m"][k])
        worst[k] = (rel, "")
        if not rel <= TRAIN_REL_TOL:
            faults.append(f"{k} {run['m'][k]} vs the CPU's {cpu['m'][k]} (rel {rel:.2e})")
    for key in ("mu", "nu", "params"):
        for (path, want), (_, got) in zip(cpu[key], run[key]):
            d = _drift(got, want)
            if key not in worst or d > worst[key][0]:
                worst[key] = (d, path)
            if key != "params" and not d <= TRAIN_LEAF_TOL:
                faults.append(f"{key} {path} drifts {d:.3e} of max |x|")
    off = n = 0
    for (path, want), (_, got), (_, mu) in zip(cpu["params"], run["params"], cpu["mu"]):
        err = (got - want).abs()
        miss = err > TRAIN_LEAF_TOL * float(want.abs().max())
        n += want.numel()
        if not miss.any():
            continue
        off += int(miss.sum())
        mu = mu.abs()
        if not bool((mu[miss] <= max(TRAIN_LEAF_TOL * float(mu.max()), mu_eps)).all()):
            faults.append(f"new {path} misses {TRAIN_LEAF_TOL} of max |x| where the grad "
                          f"is not ~0")
        if float(err[miss].max()) > 2 * lr:
            faults.append(f"new {path} beyond 2 lr of the CPU's")
    worst["near-zero-grad params"] = (off, f"of {n}")
    if off >= 1e-3 * n:
        faults.append(f"{off} of {n} new params miss {TRAIN_LEAF_TOL} of max |x|")
    return faults, worst


def train_parity(arch: str, layers: int, b: int, s: int, part: str = "b") -> dict:
    """(b) one f32 step on the card and one on the CPU from the same params
    (the reference's draw with wq and wk tamed, ``_tame``), held by
    ``_parity_faults``.  TF32 is off (phase 1).  The gate must also reject
    a step with a planted fault: the card's step on the batch with the
    second half of its tokens masked out."""
    import torch

    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.data import DataConfig, SyntheticDataset
    from repro_torch.models.params import tree_map, tree_paths
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.steps import init_model, make_train_step

    cfg = get_config(arch, n_layers=layers, dtype="float32")
    opt_cfg = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=1)
    batch = SyntheticDataset(DataConfig(cfg.vocab, s, b, seed=0)).batch(0)
    planted = dict(batch, mask=batch["mask"].copy())
    planted["mask"][:, s // 2:] = 0.0
    _, params = init_model(cfg, seed=0, device="cuda")
    params = _tame(params, cfg)
    host = lambda t: t.detach().to("cpu", copy=True)
    runs = {}
    for name, dev, data in (("cpu", "cpu", batch), ("card", "cuda", batch),
                            ("planted", "cuda", planted)):
        p = tree_map(lambda t: t.detach().to(dev, copy=True), params)  # updated in place
        t0 = time.perf_counter()
        new, opt, m = make_train_step(cfg, None, ShapeConfig("t", s, b, "train"), opt_cfg,
                                      remat=False).fn(
            p, adamw_init(p), {k: torch.from_numpy(v).to(dev) for k, v in data.items()})
        run = {"m": {k: float(v) for k, v in m.items()}, "s": time.perf_counter() - t0,
               **{k: [(path, host(t)) for path, t in tree_paths(tree)]
                  for k, tree in (("params", new), ("mu", opt["mu"]), ("nu", opt["nu"]))}}
        del p, new, opt
        if name == "cpu":
            cpu = run
        else:
            runs[name] = _parity_faults(run, cpu, cpu["m"]["lr"],
                                        (1 - opt_cfg.b1) * opt_cfg.eps) + (run,)
    del params
    torch.cuda.empty_cache()
    (faults, worst, card), (planted_faults, _, bad) = runs["card"], runs["planted"]
    if faults:
        raise AssertionError("train parity, card against CPU: " + "; ".join(faults))
    if not planted_faults:
        raise AssertionError("train parity: the gate let a step on half the tokens pass")
    log("train", f"{part}. {arch} cut to {layers} layers, f32, wq/wk tamed, B={b} S={s}: one step "
        f"on the card ({card['s']:.2f} s) and on the CPU ({cpu['s']:.2f} s): loss "
        f"{card['m']['loss']:.6f} / {cpu['m']['loss']:.6f}, grad norm "
        f"{card['m']['grad_norm']:.6f} / {cpu['m']['grad_norm']:.6f}")
    log("train", f"{part}. worst drift from the CPU (held to "
        f"{TRAIN_REL_TOL} relative, leaves {TRAIN_LEAF_TOL} of max |x|): "
        + "; ".join(f"{k} {v:.3e} {where}".rstrip() if isinstance(v, float) else
                    f"{k} {v} {where}" for k, (v, where) in worst.items()))
    log("train", f"{part}. planted fault (the card's step with tokens {s // 2}-{s - 1} masked "
        f"out; loss {bad['m']['loss']:.6f}, grad norm {bad['m']['grad_norm']:.6f}) rejected: "
        f"{len(planted_faults)} faults, first: {planted_faults[0]}")
    return {"worst": {k: v[0] for k, v in worst.items()}, "planted_faults": len(planted_faults)}


def train_breakdown() -> dict:
    """One full-width step of (a), profiled (device busy time against wall
    time, the top device ops), then the step's body once more with CUDA
    events around its forward, backward and AdamW update, and the grad
    norm of each layer's block params."""
    import torch

    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.data import DataConfig, SyntheticDataset
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.models.transformer import forward_train
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    from repro_torch.steps import init_model, make_train_step

    arch, b, s, _ = TRAIN_FULL
    cfg = get_config(arch)
    _, params = init_model(cfg, seed=0, device="cuda")
    opt = adamw_init(params)
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in
             SyntheticDataset(DataConfig(cfg.vocab, s, b, seed=0)).batch(0).items()}
    step = make_train_step(cfg, None, ShapeConfig("t", s, b, "train"), remat=False).fn
    step(params, opt, batch)  # warm-up; the params now require grad
    busy_ms, wall_ms, _ = _profile(f"{arch} train step (B={b} S={s})",
                                   lambda: step(params, opt, batch))
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    ev[0].record()
    total, _ = forward_train(params, cfg, batch, remat=False)
    ev[1].record()
    total.backward()
    ev[2].record()
    with torch.no_grad():  # each layer's grad norm, over its block leaves
        layer_norms = torch.stack([
            torch.linalg.vector_norm(p.grad, dim=tuple(range(1, p.grad.dim())),
                                     dtype=torch.float32) ** 2
            for p in tree_leaves(params["blocks"])]).sum(0).sqrt().tolist()
        ev[3].record()
        adamw_update(tree_map(lambda p: p.grad, params), opt, params, AdamWConfig())
    ev[4].record()
    torch.cuda.synchronize()
    parts = {name: ev[i].elapsed_time(ev[i + 1])
             for i, name in ((0, "forward"), (1, "backward"), (3, "adamw"))}
    log("breakdown", f"{arch} train step by part (CUDA events): "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in parts.items()))
    log("breakdown", f"{arch} grad norm of each layer's block params, layer 0 to "
        f"{len(layer_norms) - 1} (the reference's init): "
        + ", ".join(f"{x:.3g}" for x in layer_norms))
    del params, opt, step, total
    torch.cuda.empty_cache()
    return {"busy_ms": busy_ms, "wall_ms": wall_ms, "layer_grad_norms": layer_norms, **parts}


def train_resume() -> dict:
    """(c) crash at step 6 and resume from the step-4 checkpoint, on the card."""
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import ObjectStore
    from repro_torch.launch import train as T

    cfg = get_smoke_config("gemma-2b")
    full = T.train(cfg, 10, 4, 64, device="cuda")
    with tempfile.TemporaryDirectory() as d:
        mgr = lambda: CheckpointManager(ObjectStore(root=d), "ckpt", "run")
        try:
            T.train(cfg, 10, 4, 64, mgr=mgr(), ckpt_every=4, crash_at_step=6, device="cuda")
        except RuntimeError as e:
            if "injected crash at step 6" not in str(e):
                raise
        else:
            raise AssertionError("train: crash_at_step=6 did not crash")
        resumed = T.train(cfg, 10, 4, 64, mgr=mgr(), ckpt_every=4, device="cuda")
    want = full["history"][4:]
    rel = max(abs(g - w) / abs(w) for g, w in zip(resumed["history"], want))
    if resumed["start_step"] != 4 or len(resumed["history"]) != 6 or rel > RESUME_REL_TOL:
        raise AssertionError(f"train resume: {resumed} vs uninterrupted {full['history']}")
    log("train", f"c. {cfg.name} crash at step 6, resumed from step {resumed['start_step']}: "
        f"losses of steps 5-10 within {rel:.2e} relative of the uninterrupted run's "
        f"({[round(x, 4) for x in want]})")
    return {"resume_rel": rel}


def phase_train() -> dict:
    """Phase 8: training calls no kernel, so the launch counters stay as
    they are across it."""
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    before = ops.launches()
    out = {"full": train_full(*TRAIN_FULL), "breakdown": train_breakdown(),
           "parity": train_parity(*TRAIN_PARITY), "resume": train_resume()}
    for arch, b, s, steps, remat, scan in TRAIN_MORE:
        out[f"full {arch} {scan}"] = train_full(arch, b, s, steps, remat, scan, part="d")
    out["parity hybrid"] = train_parity(*TRAIN_PARITY_HYBRID, part="e")
    if ops.launches() != before:
        raise AssertionError(f"train launched kernels: {before} -> {ops.launches()}")
    out["seconds"] = time.perf_counter() - t0
    log("train", f"phase took {out['seconds']:.1f}s; kernel launches unchanged {before}")
    return out


def full_width_overrides(arch: str, **extra) -> dict:
    """A job script's ``config_overrides`` that turn ``get_smoke_config(arch)``
    into the published config (plus ``extra``): every field that differs."""
    import dataclasses

    from repro_torch.configs import get_config, get_smoke_config

    full, smoke = get_config(arch, **extra), get_smoke_config(arch)
    over = {f.name: getattr(full, f.name) for f in dataclasses.fields(full)
            if getattr(full, f.name) != getattr(smoke, f.name)}
    if get_smoke_config(arch, **json.loads(json.dumps(over))) != full:
        raise AssertionError(f"bridge: {arch}'s overrides do not restore its config")
    return over


class Slurm:
    """The twin's slurm REST routes, called as the Bridge's adapter calls
    them: ``RestServer.handle`` with the Bearer header.  Any status outside
    ``want`` fails the phase."""

    def __init__(self, server, token: str):
        self.server, self.headers = server, {"Authorization": f"Bearer {token}"}

    def __call__(self, method: str, path: str, body=None, want=(200,)):
        r = self.server.handle(method, SLURM + path, body, self.headers)
        if r.status not in want:
            raise AssertionError(f"bridge: {method} {path} -> HTTP {r.status} {r.json}")
        return r

    def submit(self, spec: dict, **job) -> str:
        return str(self("POST", "/job/submit", {"script": json.dumps(spec), "job": job,
                                                "params": {}}).json["job_id"])

    def wait(self, jid: str, states, timeout: float = BRIDGE_TIMEOUT) -> dict:
        """Poll ``GET /job/{id}`` until its state is in ``states``; a job
        that ends in another state, or takes longer, fails the phase with
        the job's reason."""
        deadline = time.perf_counter() + timeout
        while True:
            rec = self("GET", f"/job/{jid}").json["jobs"][0]
            if rec["job_state"] in states:
                return rec
            if rec["job_state"] in ("COMPLETED", "FAILED", "CANCELLED") \
                    or time.perf_counter() > deadline:
                raise AssertionError(f"bridge: job {jid} is {rec['job_state']}, want {states}; "
                                     f"reason: {rec['state_reason']!r}")
            time.sleep(0.01)


def bridge_serve(rest: Slurm, arch: str, over: dict, requests: int, threads: int,
                 new: int, shape: tuple, seed: int = 0) -> dict:
    """A serve job: submit, poll ``/health`` until 200, ``requests`` invokes
    from ``threads`` threads (every one must return ``new`` tokens, served
    by the job), then ``DELETE`` and poll until CANCELLED.  The launch
    counters are set to 0 just before the submit and read once the last
    request returned."""
    import threading

    import numpy as np

    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops

    slots, prompt, max_len = shape
    vocab = get_smoke_config(arch, **over).vocab
    rng = np.random.RandomState(seed)
    prompts = [[int(t) for t in rng.randint(1, vocab, size=prompt)] for _ in range(requests)]
    ops.reset_launches()
    t0 = time.perf_counter()
    jid = rest.submit({"mode": "serve", "arch": arch, "config_overrides": over,
                       "max_batch": slots, "prefill_len": prompt, "max_len": max_len,
                       "seed": seed})
    deadline = t0 + BRIDGE_TIMEOUT
    while rest("GET", f"/job/{jid}/health", want=(200, 503)).status != 200:
        rec = rest("GET", f"/job/{jid}").json["jobs"][0]
        if rec["job_state"] not in ("PENDING", "RUNNING") or time.perf_counter() > deadline:
            raise AssertionError(f"bridge: serve job {jid} never became healthy: "
                                 f"{rec['job_state']}, reason {rec['state_reason']!r}")
        time.sleep(0.01)
    ready_s = time.perf_counter() - t0
    todo = list(range(requests))
    lock = threading.Lock()
    lat, errors, replies = [], [], {}

    def client():
        while True:
            with lock:
                if not todo:
                    return
                i = todo.pop(0)
            t = time.perf_counter()
            try:
                body = rest("POST", f"/job/{jid}/invoke",
                            {"prompt": prompts[i], "max_new_tokens": new}).json
            except AssertionError as e:
                errors.append(str(e))
                continue
            with lock:
                lat.append(time.perf_counter() - t)
                replies[i] = body

    pool = [threading.Thread(target=client, daemon=True) for _ in range(threads)]
    t1 = time.perf_counter()
    for t in pool:
        t.start()
    for t in pool:
        t.join(timeout=max(deadline - time.perf_counter(), 1))
    wall = time.perf_counter() - t1
    launches = ops.launches()
    if any(t.is_alive() for t in pool) or errors:
        rec = rest("GET", f"/job/{jid}").json["jobs"][0]
        raise AssertionError(f"bridge: {len(replies)}/{requests} requests returned; "
                             f"errors {errors[:3]}; job {jid} {rec['job_state']}, "
                             f"reason {rec['state_reason']!r}")
    bad = [i for i, b in replies.items() if len(b["tokens"]) != new or b["served_by"] != jid]
    if bad:
        raise AssertionError(f"bridge: requests {bad} returned {[replies[i] for i in bad]}")
    t = time.perf_counter()
    for _ in range(200):  # the REST layer's own cost: a route that runs no model
        rest("GET", f"/job/{jid}/health")
    route_us = (time.perf_counter() - t) / 200 * 1e6
    rest("DELETE", f"/job/{jid}")
    rest.wait(jid, ("CANCELLED",))
    lat.sort()
    return {"job": jid, "ready_s": ready_s, "wall_s": wall, "launches": launches,
            "route_us": route_us, "prompts": prompts,
            "replies": [replies[i]["tokens"] for i in range(requests)],
            "tokens": requests * new, "tokens_per_s": requests * new / wall,
            "latency_p50_s": lat[min(len(lat) - 1, int(len(lat) * 0.50))],
            "latency_p99_s": lat[min(len(lat) - 1, int(len(lat) * 0.99))]}


def engine_tokens(arch: str, over: dict, prompts: list, new: int, shape: tuple,
                  seed: int = 0) -> list:
    """Each prompt's greedy tokens from a ``ServingEngine`` built directly
    as the serve job builds its own: the job script's config (through its
    JSON), the same seed's params, slots and lengths; in prompt order."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.steps import init_model

    slots, prompt, max_len = shape
    cfg = get_smoke_config(arch, **json.loads(json.dumps(over)))
    _, params = init_model(cfg, seed=seed, max_seq=max_len)
    eng = ServingEngine(cfg, params, max_batch=slots, max_len=max_len, prefill_len=prompt)
    rids = [eng.submit(p, max_new_tokens=new) for p in prompts]
    out = eng.run_until_idle()
    return [out[r] for r in rids]


def bridge_train(rest: Slurm, cluster, store, spec: dict, name: str, want="COMPLETED") -> dict:
    """A train job: submit, wait for ``want``; for a COMPLETED job, its
    ``train.out`` (the dialect has no download route: read from the
    cluster's job, as the Bridge's tests do) and its loss history (uploaded
    under the workdir)."""
    from repro_torch.core import ObjectStore

    t0 = time.perf_counter()
    jid = rest.submit(spec, OutputFileName="train.out")
    rec = rest.wait(jid, (want,))
    out = {"job": jid, "wall_s": time.perf_counter() - t0, "record": rec}
    if want == "COMPLETED":
        out["result"] = json.loads(cluster.get(jid).outputs["train.out"])
        bucket, prefix = ObjectStore.parse_ref(spec["workdir"])
        out["history"] = json.loads(store.get(bucket, f"{prefix}/history_{jid}.json"))
        if not all(map(math.isfinite, out["history"])) or out["result"]["state"] != "done":
            raise AssertionError(f"bridge: train {name}: {out['result']} {out['history']}")
    return out


def phase_bridge(serve_ref: dict) -> dict:
    """Phase 9: the jaxlocal twin on the card, driven over its REST routes."""
    import torch

    from repro_torch.core import ObjectStore
    from repro_torch.core.backends import jaxlocal as JX
    from repro_torch.kernels import ops

    store = ObjectStore()
    cluster = JX.make_jaxlocal_cluster(store, slots=2)  # device "cuda"
    rest = Slurm(JX.make_server(cluster, token=BRIDGE_TOKEN), BRIDGE_TOKEN)
    out = {}
    try:
        arch, requests, threads, new = BRIDGE_SERVE
        over = full_width_overrides(arch, attention_impl="pallas")
        n_layers = over["n_layers"]
        s = bridge_serve(rest, arch, over, requests, threads, new, BRIDGE_SERVE_SHAPE)
        k1, k2 = s["launches"]["flash_attention"], s["launches"]["decode_attention"]
        others = {k: v for k, v in s["launches"].items()
                  if k not in ("flash_attention", "decode_attention") and v}
        if k1 != n_layers * requests or k2 % n_layers or k2 < n_layers * (new - 1) or others:
            raise AssertionError(f"bridge: serve launches {s['launches']}, want flash_attention "
                                 f"= {n_layers} x {requests}, decode_attention a multiple of "
                                 f"{n_layers} and >= {n_layers} x {new - 1}")
        ref = serve_ref["summary"]
        log("bridge", f"serve: job {s['job']} {arch} full width {over['dtype']} pallas, healthy "
            f"{s['ready_s']:.2f}s after submit; {requests} invokes x {new} tokens from "
            f"{threads} threads over REST: {s['tokens']} tokens in {s['wall_s']:.4f}s = "
            f"{s['tokens_per_s']:.2f} tokens/s, latency p50 {s['latency_p50_s']:.3f}s p99 "
            f"{s['latency_p99_s']:.3f}s (phase 5's launch.serve, all {ref['requests']} "
            f"submitted at once: {ref['tokens_per_s']} tokens/s, p50 "
            f"{ref['latency_p50_s']:.3f}s p99 {ref['latency_p99_s']:.3f}s); launches "
            f"{s['launches']} (= {requests} prefills x {n_layers}, {k2 // n_layers} decode "
            f"ticks x {n_layers}); GET /health {s['route_us']:.1f} us a call on the live job; "
            f"then DELETE: CANCELLED")
        torch.cuda.empty_cache()
        t = time.perf_counter()
        direct = engine_tokens(arch, over, s["prompts"], new, BRIDGE_SERVE_SHAPE)
        differ = [(i, next(j for j, (a, b) in enumerate(zip(got, want)) if a != b))
                  for i, (got, want) in enumerate(zip(s["replies"], direct)) if got != want]
        if differ:
            raise AssertionError(f"bridge: {len(differ)} of {requests} requests over REST differ "
                                 f"from the engine's run of the same prompts (request, first "
                                 f"token that differs): {differ}")
        log("bridge", f"serve: all {requests} requests' tokens over REST equal to a "
            f"ServingEngine's on the same seed's params and prompts ("
            f"{len({tuple(r) for r in direct})} distinct sequences; "
            f"{time.perf_counter() - t:.2f}s with init)")
        out["serve"] = s
        torch.cuda.empty_cache()

        arch, b, seq, steps = BRIDGE_TRAIN
        before = ops.launches()
        torch.cuda.reset_peak_memory_stats()
        spec = {"arch": arch, "steps": steps, "batch": b, "seq": seq,
                "config_overrides": full_width_overrides(arch), "workdir": "runs:bridge/full"}
        t = bridge_train(rest, cluster, store, spec, "full width")
        if ops.launches() != before or len(t["history"]) != steps:
            raise AssertionError(f"bridge: train launches {before} -> {ops.launches()}, "
                                 f"history {t['history']}")
        rec = t["record"]
        log("bridge", f"train: job {t['job']} {arch} full width bf16, B={b} S={seq}, {steps} "
            f"steps, no remat: COMPLETED, losses {[round(x, 4) for x in t['history']]}, "
            f"train.out {t['result']}; {rec['end_time'] - rec['start_time']:.2f}s on its worker "
            f"(init included), {t['wall_s']:.2f}s submit to COMPLETED; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; no kernel launched")
        out["train"] = t
        torch.cuda.empty_cache()

        base = {"arch": "gemma-2b", "steps": 10, "batch": 4, "seq": 64, "lr": 1e-2}
        full = bridge_train(rest, cluster, store, dict(base, workdir="runs:bridge/whole"),
                            "uninterrupted")
        crash = dict(base, checkpoint_every=4, workdir="runs:bridge/crash")
        failed = bridge_train(rest, cluster, store, dict(crash, crash_at_step=6), "crash",
                              want="FAILED")
        if "injected crash at step 6" not in failed["record"]["state_reason"]:
            raise AssertionError(f"bridge: crash job {failed['record']}")
        resumed = bridge_train(rest, cluster, store, crash, "resume")
        want = full["history"][4:]
        rel = max(abs(g - w) / abs(w) for g, w in zip(resumed["history"], want))
        if (resumed["result"]["start_step"] != 4 or len(resumed["history"]) != 6
                or rel > RESUME_REL_TOL):
            raise AssertionError(f"bridge: resume {resumed['result']} {resumed['history']} vs "
                                 f"uninterrupted {full['history']}")
        log("bridge", f"crash: job {failed['job']} FAILED ({failed['record']['state_reason']}); "
            f"job {resumed['job']} resumed from step {resumed['result']['start_step']}: losses "
            f"of steps 5-10 within {rel:.2e} relative of job {full['job']}'s uninterrupted "
            f"run ({[round(x, 4) for x in want]})")
        out["resume_rel"] = rel
    finally:
        cluster.shutdown()
    return out


def start_dryrun():
    """The dry-run's accounting of phase 10's cells (DRYRUN_SCRIPT), started
    in a process of its own that sees no card; ``phase_cells`` waits for it."""
    import os

    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen([sys.executable, "-c", DRYRUN_SCRIPT, json.dumps([CELL, TRAIN_CELL])],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


def start_mesh_dryrun():
    """The dry-run on a mesh of phase 14 (MESH_DRYRUN_SCRIPT), in a process of
    its own that sees no card; ``phase_mesh_dryrun`` waits for it."""
    import os

    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
    job = [["gemma-2b", MESH_DENSE_LAYERS, MESH_BATCH, MESH_PROMPT, MESH_DRYRUN_SLOTS],
           list(MESH_DRYRUN_CELL)]
    return subprocess.Popen([sys.executable, "-c", MESH_DRYRUN_SCRIPT, json.dumps(job)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


def _cell_cfgs():
    """(blockwise cfg, K1 cfg, shape) of phase 10's hymba cell: the
    reference's perf override, and the same with attention_impl="pallas";
    the shape's batch cut to CELL's."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch.dryrun import _perf_overrides

    arch, shape_name, b = CELL
    cb = get_config(arch, **_perf_overrides()[(arch, shape_name)])
    return (cb, dataclasses.replace(cb, attention_impl="pallas"),
            dataclasses.replace(SHAPES[shape_name], global_batch=b))


def _held_layers(what: str, params: dict, ca, cb, tokens, window: int, want: dict) -> str:
    """Route ``ca`` held against route ``cb`` layer by layer on the same
    input (``cb``'s stream), and the logits, within PARITY_REL_TOL of max
    |x|; ``want`` = the launches of each route summed over the layers."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as TF

    def logits_of(x):
        return L.unembed(params["embed"], L.apply_norm(params["ln_f"], x[:, -1:], ca.norm), ca)

    got = {"a": dict.fromkeys(ops.KERNELS, 0), "b": dict.fromkeys(ops.KERNELS, 0)}
    worst = 0.0
    with torch.no_grad():
        x, pos, _ = TF._embed_inputs(params, ca, {"tokens": tokens})
        for li in range(ca.n_layers):
            p = TF.layer_params(params["blocks"], li)
            outs = {}
            for key, c in (("a", ca), ("b", cb)):
                ops.reset_launches()
                outs[key] = TF._apply_block(p, x, pos, c, window=window)[0]
                for name, n in ops.launches().items():
                    got[key][name] += n
            worst = max(worst, _check_rel(f"{what} layer {li}", outs["a"], outs["b"]))
            x = outs["b"]
        rel = _check_rel(f"{what} logits", logits_of(outs["a"]), logits_of(x))
    if got != want:
        raise AssertionError(f"{what}: launches {got}, want {want}")
    return f"worst layer err / max |x| {worst:.3e}, logits {rel:.3e} (tol {PARITY_REL_TOL}); " \
        f"launches {got['a']} / {got['b']}"


def _peak_check(what: str, predicted: int, measured: int) -> float:
    rel = (predicted - measured) / measured
    if abs(rel) > PEAK_REL_TOL:
        raise AssertionError(f"{what}: the dry-run's peak {predicted / 2**30:.3f} GiB is "
                             f"{rel:+.1%} off the card's {measured / 2**30:.3f} GiB")
    return rel


def _against_dryrun(what: str, rec: dict, cost, measured_peak: int, wall_s: float) -> dict:
    """The dry-run's record of a cell against the card's run of it: the peak
    within PEAK_REL_TOL of torch.cuda.max_memory_allocated, the FLOPs the
    card's counter saw equal to the meta count; the roofline terms and the
    bound's share of the measured time (not gated)."""
    rel = _peak_check(what, rec["memory"]["peak_bytes_per_device"], measured_peak)
    if cost.flops != rec["flops_per_dev"]:
        raise AssertionError(f"{what}: FLOPs counted on the card {cost.flops:.6e} != "
                             f"the dry-run's {rec['flops_per_dev']:.6e}")
    terms = rec["roofline"]
    share = terms["bound_s"] / wall_s
    log("cells", f"d. {what}: dry-run peak {rec['memory']['peak_bytes_per_device'] / 2**30:.3f} "
        f"GiB vs max_memory_allocated {measured_peak / 2**30:.3f} GiB ({rel:+.2%}, tol "
        f"{PEAK_REL_TOL:.0%}); FLOPs {cost.flops:.6e} on the card = the dry-run's; bytes "
        f"{cost.total_bytes:.4e} on the card, {rec['bytes_per_dev']:.4e} on meta; roofline: "
        f"compute {terms['compute_s'] * 1e3:.2f} ms, memory {terms['memory_s'] * 1e3:.2f} ms, "
        f"collective {terms['collective_s']:.1f} s, dominant {terms['dominant']}, bound "
        f"{terms['bound_s'] * 1e3:.2f} ms = {share:.4f} of the measured {wall_s * 1e3:.2f} ms; "
        f"the dry-run counted its cell in {rec['count_s']:.1f} s")
    return {"peak_predicted": rec["memory"]["peak_bytes_per_device"], "peak_measured": measured_peak,
            "peak_rel": rel, "flops": cost.flops, "bytes_card": cost.total_bytes,
            "bytes_meta": rec["bytes_per_dev"], "roofline": terms, "wall_ms": wall_s * 1e3,
            "bound_share": share}


def phase_cells(dryrun, kernels: list) -> dict:
    """Phase 10: the dry-run's cells on the card.

    a. hymba-1.5b at full width cut to CELL_HELD_LAYERS layers, f32, B=1,
       S=32768: the blockwise route held against the K1 route layer by
       layer on the same input (phase 4's gate), both through K3; then the
       window mode (long_window 1024): the blockwise windowed route against
       the plain windowed one at CELL_WINDOW_HELD_S tokens, where its (S,S)
       scores still fit.
    b. The cell at full depth in bf16, built with ``make_prefill_step`` on
       the K1 route and on the blockwise route (the latter under the step
       counter: it is d's card run): prefill ms, tokens/s, peak memory,
       launches; K1 and K3 at this shape beside sdpa and their bounds.
    c. The window mode at full length: a blockwise windowed prefill of the
       cell's tokens, then DECODE_STEPS greedy steps through K2 on the
       1024-slot circular cache.
    d. The dry-run's records (``dryrun``, the process ``start_dryrun``
       began) against the card: b's blockwise run, and gemma-2b's train_4k
       cell cut to B=2 (B=1 if the dry-run predicts more than
       TRAIN_CELL_MAX_BYTES), with remat, run once and then under the
       counter: the peak within PEAK_REL_TOL, the FLOPs exact."""
    import dataclasses

    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.configs import get_config
    from repro_torch.configs.base import SHAPES
    from repro_torch.kernels import ops
    from repro_torch.launch.analysis import StepCost
    from repro_torch.launch.dryrun import _perf_overrides
    from repro_torch.models import decoding as DEC
    from repro_torch.models import layers as L
    from repro_torch.models import ssm as SSM
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.steps import init_model, make_prefill_step, make_step, make_synthetic_batch

    cb, ck, shape = _cell_cfgs()
    b, s, n = shape.global_batch, shape.seq_len, cb.n_layers
    window = cb.long_window
    zero = dict.fromkeys(ops.KERNELS, 0)
    out = {}

    # a. held at CELL_HELD_LAYERS layers in f32
    t0 = time.perf_counter()
    m = CELL_HELD_LAYERS
    c32 = dataclasses.replace(cb, dtype="float32", n_layers=m)
    k32 = dataclasses.replace(ck, dtype="float32", n_layers=m)
    x32 = dataclasses.replace(cb, dtype="float32", n_layers=m, attention_impl="xla")
    _, params = init_model(c32, seed=0, max_seq=s, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(1, cb.vocab, (b, s), generator=g, device="cuda")
    msg = _held_layers("a. blockwise vs K1", params, c32, k32, tokens, 0,
                       {"a": dict(zero, ssm_scan_fused=m), "b": dict(zero, ssm_scan_fused=m,
                                                                     flash_attention=m)})
    log("cells", f"a. {CELL[0]} f32, {m} layers, B={b} S={s}: blockwise route held against the "
        f"K1 route on the same input: {msg}")
    sw = CELL_WINDOW_HELD_S
    msg = _held_layers("a. windowed blockwise vs plain", params, c32, x32, tokens[:, :sw], window,
                       {"a": dict(zero, ssm_scan_fused=m), "b": dict(zero, ssm_scan_fused=m)})
    log("cells", f"a. window {window}, S={sw}: windowed blockwise route held against the plain "
        f"windowed route: {msg}; {time.perf_counter() - t0:.1f}s")
    del params, tokens
    torch.cuda.empty_cache()

    # b. full depth, bf16, both routes through make_prefill_step
    t0 = time.perf_counter()
    base = torch.cuda.memory_allocated()
    _, params = init_model(cb, seed=0, max_seq=s, device="cuda")
    batch = make_synthetic_batch(cb, shape, seed=1, device="cuda")
    torch.cuda.synchronize()
    log("cells", f"b. {CELL[0]} {cb.dtype} full width and depth ({n} layers), {CELL[1]} cut from "
        f"B={SHAPES[CELL[1]].global_batch} to B={b}, S={s}; init {time.perf_counter() - t0:.1f}s")
    rec = dryrun.result()
    runs = {}
    for route, cfg in (("K1", ck), ("blockwise", cb)):
        bundle = make_prefill_step(cfg, None, shape)
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        counted = route == "blockwise"
        cost = StepCost({"params": params, "batch": batch}, device="cuda") if counted else None
        with cost or contextlib.nullcontext():
            t1 = time.perf_counter()
            logits, cache = bundle.fn(params, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
        launches = ops.launches()
        want = dict(zero, ssm_scan_fused=n, flash_attention=n if route == "K1" else 0)
        if launches != want:
            raise AssertionError(f"b. {route} route launches {launches}, want {want}")
        if tuple(logits.shape) != (b, 1, cb.vocab) or not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"b. {route} route logits {tuple(logits.shape)}, or not finite")
        peak = torch.cuda.max_memory_allocated() - base
        runs[route] = {"prefill_ms": wall * 1e3, "tokens_per_s": b * s / wall,
                       "peak_bytes": peak, "launches": launches, "logits": logits.float()}
        log("cells", f"b. {route} route" + (" (under the step counter: d's card run)" if counted
                                            else "") + f": prefill {wall * 1e3:.2f} ms, "
            f"{b * s / wall:.1f} tokens/s, peak memory {peak / 2**30:.3f} GiB ({peak} bytes), "
            f"launches {launches}, cache K {tuple(cache['k'].shape)}")
        del cache, logits
        if counted:
            out["d_cell"] = _against_dryrun(f"{CELL[0]} {CELL[1]} B={b} blockwise", rec["cell"],
                                            cost, peak, wall)
    drift = _rel(runs["blockwise"].pop("logits"), runs["K1"].pop("logits"))
    log("cells", f"b. last-token logits, blockwise vs K1 route at full depth in bf16 (not held: "
        f"bf16 rounding through {n} chaotic layers): err / max |logit| {drift:.3e}")
    out["b"] = runs

    # K1 and K3 at the cell's shape, beside sdpa and their bounds
    hq, hkv, d = cb.n_heads, cb.n_kv_heads, cb.resolved_head_dim
    q, k, v = _flash_inputs(b, s, hq, hkv, d, torch.bfloat16, seed=7)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                      SDPBackend.CUDNN_ATTENTION]):  # never the math backend's S x S scores
        k1 = {"ms": device_ms(lambda: ops.flash_attention(q, k, v), iters=3, warmup=1),
              "library_ms": device_ms(lambda: F.scaled_dot_product_attention(
                  qt, kt, vt, is_causal=True, enable_gqa=True), iters=3, warmup=1)}
    # the plain version here is the blockwise attention (K1's plain version
    # would hold 107 GB of scores)
    k1["plain_ms"] = queued_ms(lambda: L._blockwise_attention(q, k, v, cb, 0), iters=1)
    exp_rate = sfu_exp_rate()
    flops, nbytes = ops.kernel_cost("flash_attention", q, k, v)
    k1 |= _bound(flops, nbytes, BF16_FLOPS, exp_rate)
    # K1's query rows in three 64-row blocks (the first, two tiles across
    # the middle, the last) against its plain version's arithmetic (f32
    # scores, -inf masking, f32 softmax) over the keys each block sees.
    # Held relative to the block's max |want|: with randn inputs an output's
    # scale falls as sqrt(e / keys), to ~0.009 at the last rows
    got = ops.flash_attention(q, k, v)
    kf, vf = (t.float().repeat_interleave(hq // hkv, dim=2).transpose(1, 2) for t in (k, v))
    k1_held = {}
    for lo in (0, s // 2 - 32, s - 64):
        hi = lo + 64
        sc = q[:, lo:hi].float().transpose(1, 2) @ kf[:, :, :hi].transpose(-1, -2) / math.sqrt(d)
        sc = sc.masked_fill(torch.arange(hi, device="cuda")[None, :]
                            > torch.arange(lo, hi, device="cuda")[:, None], float("-inf"))
        want = (torch.softmax(sc, dim=-1) @ vf[:, :, :hi]).transpose(1, 2).to(q.dtype)
        rel = _hold(f"K1 at S={s}, query rows {lo}-{hi - 1}", _rel(got[:, lo:hi], want),
                    TOL["bfloat16"])
        k1_held[f"{lo}-{hi - 1}"] = {"max_abs_err": max_err(got[:, lo:hi], want), "rel_err": rel,
                                     "max_abs_want": float(want.float().abs().max())}
    k1.update(max_abs_err=max(r["max_abs_err"] for r in k1_held.values()),
              rel_err=max(r["rel_err"] for r in k1_held.values()))
    del q, k, v, qt, kt, vt, kf, vf, sc, want, got
    di, ns = cb.ssm.d_inner(cb.d_model), cb.ssm.d_state
    delta, B, C, x, A = _scan_inputs(b, s, di, ns, seed=9)
    plain = {}

    def chunked():  # keeps its output, which K3 is held against below
        plain["out"] = SSM._chunked_selective_scan(delta, B, C, x, A, cb.ssm.chunk)

    k3 = {"ms": device_ms(lambda: ops.ssm_scan_fused(delta, B, C, x, A), iters=5, warmup=1),
          "library_ms": None,
          # the plain version here is the model's chunked training scan (the
          # one-step-at-a-time oracle would take S host steps)
          "plain_ms": queued_ms(chunked, iters=1)}
    flops, nbytes = ops.kernel_cost("ssm_scan_fused", delta, B, C, x, A)
    k3 |= _bound(flops, nbytes, F32_FLOPS, exp_rate, exps=b * s * di * ns)
    # K3's y and h_last over all s steps (its carry across s / 512 windows)
    # against the chunked scan's, each relative to its max |want|
    for what, got, want in zip(("y", "h_last"), ops.ssm_scan_fused(delta, B, C, x, A),
                               plain["out"]):
        k3[f"{what}_rel_err"] = _hold(f"K3 at S={s} {what}", _rel(got, want), TOL["float32"])
        k3["max_abs_err"] = max(k3.get("max_abs_err", 0.0), max_err(got, want))
    del delta, B, C, x, A, plain, got, want
    for name, row, shp in (("flash_attention", k1, f"B={b} S={s} Hq={hq} Hkv={hkv} D={d} bf16"),
                           ("ssm_scan_fused", k3, f"B={b} S={s} di={di} N={ns} f32")):
        row.update(shape=shp, launches=runs["K1"]["launches"][name],
                   ms_over_library=row["ms"] / row["library_ms"] if row["library_ms"] else None,
                   bound_over_ms=row["bound_ms"] / row["ms"])
        for entry in kernels:
            if entry["name"] == name:
                entry[f"at_{CELL[0]} {CELL[1]}"] = row
        log("cells", f"b. {name} at {shp}: device time {row['ms'] * 1e3:.2f} us"
            + (f", sdpa {row['library_ms'] * 1e3:.2f} us (kernel / sdpa "
               f"{row['ms_over_library']:.3f})" if row["library_ms"] else ", no library call")
            + f"; plain ({'blockwise attention' if name == 'flash_attention' else 'chunked scan'}, "
            f"CUDA events) {row['plain_ms'] * 1e3:.2f} us; bound {row['bound_ms'] * 1e3:.3f} us "
            f"({row['bound_by']}), bound / kernel {row['bound_over_ms']:.4f}; "
            f"{row['launches']} launches on the K1 route's prefill")
    log("cells", f"b. K1 at S={s} against its plain version's arithmetic, by query rows, "
        f"max_abs_err / max |want| within {TOL['bfloat16']}: " + "; ".join(
            f"rows {rows}: {r['max_abs_err']:.3e} / {r['max_abs_want']:.3e} = {r['rel_err']:.3e}"
            for rows, r in k1_held.items()) + "; ok")
    log("cells", f"b. K3 at S={s} against the chunked scan, max_abs_err / max |want| within "
        f"{TOL['float32']}: y {k3['y_rel_err']:.3e}, h_last {k3['h_last_rel_err']:.3e}; ok")

    # c. the window mode at full length, then DECODE_STEPS steps through K2
    steps_n = DECODE_STEPS
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t1 = time.perf_counter()
    logits, cache = DEC.prefill(params, cb, batch, max_len=s + steps_n, window=window)
    nxt = logits.argmax(-1)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t1) * 1e3
    after_prefill = ops.launches()
    finite = torch.isfinite(logits).all()
    toks = []
    t1 = time.perf_counter()
    for _ in range(steps_n):
        logits, cache = DEC.decode_step(params, ck, cache, nxt, window=window)
        nxt = logits.argmax(-1)
        finite &= torch.isfinite(logits).all()
        toks.append(nxt)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t1) * 1e3
    launches = ops.launches()
    peak = torch.cuda.max_memory_allocated() - base
    if after_prefill != dict(zero, ssm_scan_fused=n):
        raise AssertionError(f"c. windowed blockwise prefill launches {after_prefill}")
    if launches != dict(zero, ssm_scan_fused=n, decode_attention=n * steps_n):
        raise AssertionError(f"c. launches {launches}, want {n} K2 a step")
    if tuple(cache["k"].shape) != (n, b, window, hkv, d) or not bool(finite):
        raise AssertionError(f"c. cache K {tuple(cache['k'].shape)}, logits finite {bool(finite)}")
    toks = torch.cat(toks, dim=1)
    # K2 at this step's shape (B = b, the circular cache of `window` slots,
    # every slot valid after the wrap, hymba's heads, bf16) against its
    # plain version, relative to max |want|
    qd, kd, vd, lens = _decode_inputs(b, window, hq, hkv, d, torch.bfloat16, 11, [window] * b)
    want = decode_plain(qd, kd, vd, lens)
    k2_rel = _hold(f"K2 at B={b} M={window}", _rel(ops.decode_attention(qd, kd, vd, lens), want),
                   TOL["bfloat16"])
    del qd, kd, vd, lens, want
    out["c"] = {"prefill_ms": prefill_ms, "step_ms": decode_ms / steps_n,
                "tokens_per_s": b * steps_n / (decode_ms / 1e3), "peak_bytes": peak,
                "k2_rel_err": k2_rel}
    log("cells", f"c. window {window}: blockwise windowed prefill of {s} tokens {prefill_ms:.2f} "
        f"ms ({b * s / prefill_ms * 1e3:.1f} tokens/s), {steps_n} greedy steps through K2 "
        f"{decode_ms:.2f} ms = {out['c']['step_ms']:.2f} ms a step, "
        f"{out['c']['tokens_per_s']:.1f} tokens/s; peak memory {peak / 2**30:.3f} GiB; launches "
        f"{after_prefill} after the prefill, {launches} after the steps; {b} x {steps_n} "
        f"finite tokens, {toks[0, :8].tolist()}...; K2 at B={b} M={window} Hq={hq} Hkv={hkv} "
        f"D={d} bf16, every slot valid, against its plain version: max_abs_err / max |want| "
        f"{k2_rel:.3e} (within {TOL['bfloat16']}); ok")
    del params, batch, cache, logits
    torch.cuda.empty_cache()

    # d. gemma-2b's train_4k cell: the dry-run's pick of B, then the card
    arch, shape_name, batches = TRAIN_CELL
    bt = next((bt for bt in batches if rec[f"train {bt}"]["memory"]["peak_bytes_per_device"]
               <= TRAIN_CELL_MAX_BYTES), batches[-1])
    trec = rec[f"train {bt}"]
    tcfg = get_config(arch, **_perf_overrides().get((arch, shape_name), {}))
    tshape = dataclasses.replace(SHAPES[shape_name], global_batch=bt)
    bundle = make_step(tcfg, None, tshape)
    t0 = time.perf_counter()
    base = torch.cuda.memory_allocated()
    _, params = init_model(tcfg, seed=0, max_seq=tshape.seq_len, device="cuda")
    inputs = {"params": params, "opt_state": adamw_init(params),
              "batch": make_synthetic_batch(tcfg, tshape, seed=1, device="cuda")}
    ops.reset_launches()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    metrics = bundle.fn(**inputs)[2]
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t1
    torch.cuda.reset_peak_memory_stats()
    with StepCost(inputs, device="cuda") as cost:
        t1 = time.perf_counter()
        metrics2 = bundle.fn(**inputs)[2]
        torch.cuda.synchronize()
        counted_s = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated() - base
    losses = [float(metrics["loss"]), float(metrics2["loss"])]
    if ops.launches() != zero or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"d. {arch} train: launches {ops.launches()}, losses {losses}")
    log("cells", f"d. {arch} {shape_name} cut from B={SHAPES[shape_name].global_batch} to B={bt} "
        f"(the dry-run predicts " + ", ".join(
            f"B={x}: {rec[f'train {x}']['memory']['peak_bytes_per_device'] / 2**30:.2f} GiB"
            for x in batches) + f"), remat: a step {step_s * 1e3:.2f} ms, under the counter "
        f"{counted_s * 1e3:.2f} ms; losses {losses}; init {init_s:.1f}s")
    out["d_train"] = _against_dryrun(f"{arch} {shape_name} B={bt}", trec, cost, peak, step_s)
    out["d_train"]["batch"] = bt
    del params, inputs, metrics, metrics2
    torch.cuda.empty_cache()
    return out


def _mesh_gather_bytes(cfg, b: int, m_len: int, model: int) -> float:
    """Bytes one rank of a (1, ``model``) mesh gathers per decode step to
    bring the stored K/V cache (``cache_pspecs``) to K2's layout
    (``layers._attention_layouts``): the growth of its local K and V, all
    layers.  0 where the cache is stored in the kernel's layout."""
    from repro_torch import sharding as SH
    from repro_torch.models import decoding as DEC
    from repro_torch.models import layers as L

    mesh = {"data": 1, "model": model}
    spec = DEC.cache_specs(cfg, b, m_len)
    stored = SH.placements(SH.cache_pspecs(cfg, spec, mesh)["k"], mesh)
    want = L._attention_layouts(mesh, b, cfg.n_heads, cfg.n_kv_heads)[1]

    def local(pl):  # elements of a rank's shard of one layer's K
        n = spec["k"][0].numel()
        for size, p in zip(mesh.values(), pl):
            n //= size if p.is_shard() else 1
        return n
    grow = local(want) - local(stored)
    return float(max(grow, 0) * 2 * cfg.n_layers * spec["k"].element_size())


def _placed(params) -> bool:
    from torch.distributed.tensor import DTensor

    from repro_torch.models.params import tree_leaves

    return isinstance(tree_leaves(params)[0], DTensor)


def _mesh_run(arch: str, cfg, mesh, params, batch: dict, steps: int,
              m_len: int | None = None, feed=None) -> dict:
    """One prefill of ``batch`` (the tokens and the stub frontend's
    embeddings) and ``steps`` greedy decode steps through the bundles on
    ``mesh`` (None: one device) with a cache of ``m_len`` slots (default:
    prompt + steps), the launch counters set to 0 just before and read just
    after, the peak memory from just before.  ``feed`` (B, steps), if given,
    is the tokens fed to the steps in place of the greedy ones (another
    run's "fed").  On a mesh, plain ``params`` are placed by the prefill
    bundle's specs; DTensor ones must be placed so already; the cache must
    come out placed by the decode bundle's ``out_shardings``."""
    import torch

    from repro_torch import sharding as SH
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.steps import make_decode_step, make_prefill_step

    b, prompt = batch["tokens"].shape
    m_len = m_len or prompt + steps
    pre = make_prefill_step(cfg, mesh, ShapeConfig("prefill", m_len, b, "prefill"))
    dec = make_decode_step(cfg, mesh, ShapeConfig("decode", m_len, b, "decode"))
    if mesh is not None and _placed(params):  # restored onto the bundle's specs
        SH.check_placed(params, mesh, pre.in_shardings[0], f"mesh {arch} params")
    elif mesh is not None:
        params = SH.distribute(params, mesh, pre.in_shardings[0])

    def place(inputs, spec):  # the batch as the bundle takes it
        return inputs if mesh is None else SH.distribute(inputs, mesh, spec)
    pre_spec, dec_spec = (pre.in_shardings[1], dec.in_shardings[2]) if mesh else (None, None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    SH.relayout.gathered_bytes = 0
    t0 = time.perf_counter()
    logits, cache = pre.fn(params, place(batch, pre_spec))
    nxt = logits.argmax(-1)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_gathered = SH.relayout.gathered_bytes
    SH.relayout.gathered_bytes = 0
    all_logits, toks, fed = [logits], [], []
    t0 = time.perf_counter()
    for i in range(steps):
        if feed is not None:
            nxt = feed[:, i:i + 1]
        fed.append(nxt)
        logits, cache = dec.fn(params, cache, place({"tokens": nxt}, dec_spec))
        nxt = logits.argmax(-1)
        all_logits.append(logits)
        toks.append(nxt)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    launches = ops.launches()
    if mesh is not None:
        SH.check_placed(cache, mesh, dec.out_shardings[1], f"mesh {arch} cache")
    return {"logits": torch.stack([lg.float() for lg in all_logits]),
            "tokens": torch.cat(toks, dim=1), "fed": torch.cat(fed, dim=1),
            "launches": launches, "prefill_ms": prefill_ms,
            "step_ms": step_ms, "gathered_per_step": SH.relayout.gathered_bytes / steps,
            "prefill_gathered": prefill_gathered, "peak": torch.cuda.max_memory_allocated()}


def _hold_local_heads(what: str, hq: int, hkv: int, d: int, model: int,
                      s: int = MESH_PROMPT, m_len: int = MESH_PROMPT + DECODE_STEPS,
                      tag: str = "mesh") -> None:
    """K1 (S = ``s``) and K2 (a cache of ``m_len``) at full width on each of
    ``model`` ranks' heads (q's sliced, kv's sliced when Hkv divides
    ``model``, else whole: the rule of ``layers._attention_layouts``), bf16,
    B = MESH_BATCH: each rank's call against the plain version on the same
    local tensors, and the ranks' outputs together against the plain
    version on all heads."""
    import torch

    b = MESH_BATCH
    lq, split_kv = hq // model, hkv % model == 0
    lkv = hkv // model if split_kv else hkv
    if hq % model or not (split_kv or hkv == 1):
        raise AssertionError(f"{what}: {hq}/{hkv} heads have no exact split over {model}")
    q, k, v = _flash_inputs(b, s, hq, hkv, d, torch.bfloat16, 110 + model)
    lengths = torch.randint(1, m_len + 1, (b,), generator=torch.Generator().manual_seed(model))
    dq, dk, dv, dl = _decode_inputs(b, m_len, hq, hkv, d, torch.bfloat16, 120 + model,
                                    lengths.tolist())
    from repro_torch.kernels import ops

    worst, outs, douts = 0.0, [], []
    for r in range(model):
        hs = slice(r * lq, (r + 1) * lq)
        ks = slice(r * lkv, (r + 1) * lkv) if split_kv else slice(None)
        args = (q[:, :, hs], k[:, :, ks], v[:, :, ks])
        outs.append(ops.flash_attention(*[a.contiguous() for a in args]))
        worst = max(worst, check_close(f"{what} K1 rank {r}", outs[-1], flash_plain(*args),
                                       "bfloat16"))
        dargs = (dq[:, :, hs], dk[:, :, ks], dv[:, :, ks])
        douts.append(ops.decode_attention(*[a.contiguous() for a in dargs], dl))
        worst = max(worst, check_close(f"{what} K2 rank {r}", douts[-1],
                                       decode_plain(*dargs, dl), "bfloat16"))
    check_close(f"{what} K1 ranks together", torch.cat(outs, dim=2), flash_plain(q, k, v),
                "bfloat16")
    check_close(f"{what} K2 ranks together", torch.cat(douts, dim=2),
                decode_plain(dq, dk, dv, dl), "bfloat16")
    log(tag, f"{what}: K1 (B={b}, S={s}) and K2 (M={m_len}, lengths "
        f"{int(lengths.min())}..{int(lengths.max())}) on each of {model} ranks' heads (Hq "
        f"{lq}, Hkv {lkv}, D {d}) within bf16 tol of their plain versions, max_abs_err "
        f"{worst:.3e}; the ranks together equal the plain version on {hq}/{hkv} heads")


@contextlib.contextmanager
def mesh_group():
    """A one-rank NCCL process group and its (1, 1) mesh, shared by phases
    11-14, destroyed on the way out."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        mesh = make_local_mesh(1, 1)
        log("mesh", f"{mesh}: axes {mesh.mesh_dim_names}, backend {dist.get_backend()}, "
            f"world size {dist.get_world_size()}")
        yield mesh
    finally:
        dist.destroy_process_group()


def phase_mesh(mesh) -> dict:
    """Phase 11: the sharded prefill and decode bundles on the (1, 1) NCCL
    mesh against the same bundles on one device, then K1 and K2 at the local
    shapes of a "model" axis (see the module docstring)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.steps import init_model

    out = {}
    for arch, layers in MESH_RUNS:
        t0 = time.perf_counter()
        cfg = get_config(arch, attention_impl="pallas")
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        steps, m_len = DECODE_STEPS, MESH_PROMPT + DECODE_STEPS
        _, params = init_model(cfg, seed=0, max_seq=m_len, device="cuda")
        g = torch.Generator(device="cuda").manual_seed(11)
        tokens = torch.randint(1, cfg.vocab, (MESH_BATCH, MESH_PROMPT), generator=g,
                               device="cuda", dtype=torch.int32)
        plain = _mesh_run(arch, cfg, None, params, {"tokens": tokens}, steps)
        sharded = _mesh_run(arch, cfg, mesh, params, {"tokens": tokens}, steps)
        want = dict.fromkeys(ops.KERNELS, 0)
        want.update(flash_attention=cfg.n_layers, decode_attention=cfg.n_layers * steps)
        if cfg.family == "hybrid":
            want["ssm_scan"] = cfg.n_layers
        for name, run in (("mesh=None", plain), ("mesh", sharded)):
            if run["launches"] != want:
                raise AssertionError(f"mesh {arch} {name}: launches {run['launches']}, "
                                     f"want {want}")
        if not torch.equal(sharded["tokens"], plain["tokens"]):
            raise AssertionError(f"mesh {arch}: greedy tokens differ from mesh=None's")
        err = check_close(f"mesh {arch} logits", sharded["logits"], plain["logits"],
                          "bfloat16")
        if not bool(torch.isfinite(plain["logits"]).all()):
            raise AssertionError(f"mesh {arch}: non-finite logits")
        predicted = {m: _mesh_gather_bytes(cfg, MESH_BATCH, m_len, m)
                     for m in MESH_MODEL_AXES[arch]}
        depth = f"depth cut to {layers} layers" if layers else "full depth"
        log("mesh", f"{arch} bf16 full width, {depth} ({cfg.n_layers} layers), B="
            f"{MESH_BATCH}, {MESH_PROMPT}-token prompts, {steps} greedy steps: tokens "
            f"equal to mesh=None's ({MESH_BATCH} x {steps}, first row "
            f"{sharded['tokens'][0, :8].tolist()}...), logits max_abs_err {err:.3e}; "
            f"launches {sharded['launches']} on both")
        log("mesh", f"{arch}: prefill {sharded['prefill_ms']:.2f} ms on the mesh vs "
            f"{plain['prefill_ms']:.2f} ms with mesh=None; decode step "
            f"{sharded['step_ms']:.2f} ms vs {plain['step_ms']:.2f} ms "
            f"(x{sharded['step_ms'] / plain['step_ms']:.2f}: DTensor's host overhead, "
            f"{(sharded['step_ms'] - plain['step_ms']) / cfg.n_layers:.2f} ms a layer)")
        log("mesh", f"{arch}: bytes gathered per decode step on (1, 1): "
            f"{sharded['gathered_per_step']:.0f} (prefill {sharded['prefill_gathered']:.0f});"
            " a rank of a (1, m) mesh would gather " + ", ".join(
                f"m={m}: {v:.0f} ({v / 2**20:.2f} MiB)" for m, v in predicted.items())
            + f"; {time.perf_counter() - t0:.1f}s with init")
        out[arch] = {k: v for k, v in sharded.items() if k not in ("logits", "tokens")}
        out[arch]["plain"] = {k: plain[k] for k in ("prefill_ms", "step_ms", "launches")}
        del params, plain, sharded
        torch.cuda.empty_cache()
    for arch, model in (("gemma-2b", 2), ("gemma-2b", 4), ("hymba-1.5b", 5)):
        cfg = get_config(arch)
        _hold_local_heads(f"{arch} at model={model}", cfg.n_heads, cfg.n_kv_heads,
                          cfg.resolved_head_dim, model)
    return out


def _dp_train_bytes(cfg, dp: int) -> tuple:
    """(reduced, gathered) bytes one rank of a (``dp``, 1) mesh moves in a
    train step under tp and ZeRO-1, from the specs: every grad is
    ``Partial`` over "data" (the batch is split) and reduced whole, and each
    param whose moments ZeRO-1 shards over "data" is gathered back, the
    (dp - 1) / dp of it this rank did not update."""
    from repro_torch import sharding as SH
    from repro_torch.models.params import tree_leaves
    from repro_torch.models.transformer import model_defs
    from repro_torch.optim import opt_pspecs

    mesh = {"data": dp, "model": 1}
    defs = model_defs(cfg, max_seq=MESH_TRAIN_S)
    mu = opt_pspecs(defs, SH.make_rules(mesh, "tp"), mesh)["mu"]
    reduced = gathered = 0
    for d, spec in zip(tree_leaves(defs), tree_leaves(mu)):
        nbytes = math.prod(d.shape) * d.dtype.itemsize
        reduced += nbytes
        if "data" in spec.entries:
            gathered += nbytes * (dp - 1) // dp
    return reduced, gathered


def _train_run(cfg, mesh, steps: int) -> dict:
    """``steps`` AdamW steps through ``make_train_step`` (tp, ZeRO-1, remat)
    on ``mesh`` (None: one device) from ``init_model``'s seed-0 params, on
    the synthetic task's batches: the metrics of each step, ms a step over
    steps 2 on, the bytes reduced and gathered a step, the peak memory, and
    the trained state, on the card."""
    import torch

    from repro_torch import sharding as SH
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import DataConfig, SyntheticDataset
    from repro_torch.kernels import ops
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.steps import init_model, make_train_step

    b, s = MESH_TRAIN_B, MESH_TRAIN_S
    bundle = make_train_step(cfg, mesh, ShapeConfig("train", s, b, "train"),
                             AdamWConfig(**MESH_TRAIN_OPT))
    _, params = init_model(cfg, seed=0, max_seq=s, device="cuda")
    if mesh is None:
        opt = adamw_init(params)
    else:
        params = SH.distribute(params, mesh, bundle.in_shardings[0])
        opt = adamw_init(params, bundle.in_shardings[1])
    ds = SyntheticDataset(DataConfig(cfg.vocab, s, b, seed=0))
    before = ops.launches()
    SH.relayout.gathered_bytes = SH.relayout.reduced_bytes = 0
    torch.cuda.reset_peak_memory_stats()
    metrics, stamps = [], [time.perf_counter()]
    for i in range(steps):
        batch = {k: torch.from_numpy(v).to("cuda") for k, v in ds.batch(i).items()}
        if mesh is not None:
            batch = SH.distribute(batch, mesh, bundle.in_shardings[2])
        params, opt, m = bundle.fn(params, opt, batch)
        metrics.append({k: float(v) for k, v in m.items()})  # float() waits for the step
        stamps.append(time.perf_counter())
    if ops.launches() != before:
        raise AssertionError(f"train on mesh={mesh}: kernels launched {before} -> "
                             f"{ops.launches()}")
    for i, m in enumerate(metrics):
        if not all(map(math.isfinite, m.values())) or m["grad_norm"] <= 0:
            raise AssertionError(f"train on mesh={mesh}: step {i + 1} metrics {m}")
    return {"metrics": metrics, "first_ms": (stamps[1] - stamps[0]) * 1e3,
            "ms": (stamps[-1] - stamps[1]) / (steps - 1) * 1e3,
            "reduced": SH.relayout.reduced_bytes / steps,
            "gathered": SH.relayout.gathered_bytes / steps,
            "peak": torch.cuda.max_memory_allocated(), "params": params, "opt": opt,
            "bundle": bundle}


def _held_params(what: str, got, want_host: list) -> float:
    """Each leaf of ``got`` (on the card; DTensors gathered whole) within the
    bf16 tolerance of its host copy in ``want_host``, relative to the leaf's
    max |x|; returns the worst such share."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models.params import tree_paths

    worst = 0.0
    for (path, t), w in zip(tree_paths(got), want_host):
        t = (t.full_tensor() if isinstance(t, DTensor) else t).detach().float()
        w = w.to(t.device).float()
        rel = float((t - w).abs().max() / w.abs().max().clamp_min(1e-30))
        if rel > TOL["bfloat16"]:
            raise AssertionError(f"{what} {path}: max err {rel:.3e} of max |x| > bf16 tol")
        worst = max(worst, rel)
    return worst


def _exact(what: str, got, want) -> None:
    """Every leaf of ``got`` equal to ``want``'s, bit for bit, and placed as
    it (DTensors compared as their local tensors)."""
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.models.params import tree_paths

    for (path, g), (_, w) in zip(tree_paths(got), tree_paths(want)):
        if isinstance(g, DTensor):
            if tuple(g.placements) != tuple(w.placements):
                raise AssertionError(f"{what} {path}: placed {g.placements}, not "
                                     f"{w.placements}")
            g, w = g.to_local(), w.to_local()
        if g.dtype != w.dtype or not torch.equal(g, w.detach()):
            raise AssertionError(f"{what} {path}: not the saved values")


def _checkpoint_and_serve(cfg, mesh, run: dict) -> dict:
    """(c) ``run``'s trained opt state and params saved from the mesh to an
    in-memory ``ObjectStore`` and restored, the opt state with its
    ``opt_pspecs`` and the params with the prefill bundle's
    ``in_shardings[0]``, both exact (the trained tensors are freed as each
    is checked); then a prefill of B x prompt and greedy steps through the
    mesh bundles and ``mesh=None`` on the restored params: tokens equal,
    launches K1 = n_layers and K2 = n_layers x steps on both."""
    import dataclasses

    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import ObjectStore
    from repro_torch.kernels import ops
    from repro_torch.models.params import tree_map
    from repro_torch.steps import make_prefill_step

    serve_cfg = dataclasses.replace(cfg, attention_impl="pallas")
    steps, m_len = DECODE_STEPS, MESH_PROMPT + DECODE_STEPS
    pre = make_prefill_step(serve_cfg, mesh, ShapeConfig("prefill", m_len, MESH_BATCH,
                                                         "prefill"))
    store, n, out = ObjectStore(), len(run["metrics"]), {}

    def round_trip(key: str, state, specs):
        mgr = CheckpointManager(store, "ckpt", f"mesh/{key}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save(n, state)
        out[f"{key}_save_s"] = time.perf_counter() - t0
        out[f"{key}_bytes"] = sum(len(store.get("ckpt", k))
                                  for k in store.list("ckpt", f"mesh/{key}/"))
        t0 = time.perf_counter()
        step, restored, _ = mgr.restore_latest(state, shardings=specs, mesh=mesh)
        torch.cuda.synchronize()
        out[f"{key}_restore_s"] = time.perf_counter() - t0
        if step != n:
            raise AssertionError(f"ckpt {key}: restored step {step}, saved {n}")
        _exact(f"ckpt {key}", restored, state)
        return restored

    round_trip("opt", run.pop("opt"), run["bundle"].in_shardings[1])  # both freed
    torch.cuda.empty_cache()
    params = round_trip("params", run.pop("params"), pre.in_shardings[0])
    torch.cuda.empty_cache()
    g = torch.Generator(device="cuda").manual_seed(11)
    tokens = torch.randint(1, cfg.vocab, (MESH_BATCH, MESH_PROMPT), generator=g,
                           device="cuda", dtype=torch.int32)
    sharded = _mesh_run(cfg.name, serve_cfg, mesh, params, {"tokens": tokens}, steps)
    plain = _mesh_run(cfg.name, serve_cfg, None, tree_map(lambda t: t.full_tensor(), params),
                      {"tokens": tokens}, steps)
    want = dict.fromkeys(ops.KERNELS, 0)
    want.update(flash_attention=cfg.n_layers, decode_attention=cfg.n_layers * steps)
    for name, r in (("mesh=None", plain), ("mesh", sharded)):
        if r["launches"] != want:
            raise AssertionError(f"ckpt serve {name}: launches {r['launches']}, want {want}")
    if not torch.equal(sharded["tokens"], plain["tokens"]):
        raise AssertionError("ckpt serve: greedy tokens differ from mesh=None's")
    if not bool(torch.isfinite(plain["logits"]).all()):
        raise AssertionError("ckpt serve: non-finite logits")
    out["logits_err"] = check_close("ckpt serve logits", sharded["logits"], plain["logits"],
                                    "bfloat16")
    out.update(launches=sharded["launches"], prefill_ms=sharded["prefill_ms"],
               step_ms=sharded["step_ms"], plain_prefill_ms=plain["prefill_ms"],
               plain_step_ms=plain["step_ms"], first_tokens=sharded["tokens"][0, :8].tolist())
    del params, sharded, plain
    torch.cuda.empty_cache()
    return out


def _train_pair(arch: str, cfg, mesh, steps: int, tag: str) -> tuple:
    """``_train_run`` with ``mesh=None``, then on ``mesh``, one on the card at a
    time (the first's params kept on the host): losses, aux and grad norms
    within the bf16 tolerance (relative), every param within it of its max
    |x|.  Returns (the mesh run, the plain run's ms, first_ms and peak, its
    metrics, the worst param's share)."""
    import torch

    from repro_torch.models.params import tree_leaves

    plain = _train_run(cfg, None, steps)
    host = [t.detach().to("cpu", copy=True) for t in tree_leaves(plain["params"])]
    plain_metrics = plain["metrics"]
    plain = {k: plain[k] for k in ("ms", "first_ms", "peak")}
    torch.cuda.empty_cache()
    run = _train_run(cfg, mesh, steps)
    for i, (g, w) in enumerate(zip(run["metrics"], plain_metrics)):
        for k in ("loss", "aux", "grad_norm"):
            if abs(g[k] - w[k]) > TOL["bfloat16"] * abs(w[k]):
                raise AssertionError(f"{tag} {arch} step {i + 1} {k}: {g[k]} on the mesh, "
                                     f"{w[k]} with mesh=None")
    return run, plain, plain_metrics, _held_params(f"{tag} {arch}", run["params"], host)


def phase_mesh_train(mesh) -> dict:
    """Phase 12: the sharded train step on the (1, 1) NCCL mesh against the
    same steps with ``mesh=None``, then the trained state checkpointed,
    restored onto the serving bundles' shardings and served (see the module
    docstring)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.params import count_params
    from repro_torch.models.transformer import model_defs

    out = {}
    for arch, layers, steps in MESH_TRAIN_RUNS:
        t0 = time.perf_counter()
        cfg = get_config(arch)
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        run, plain, plain_metrics, worst = _train_pair(arch, cfg, mesh, steps, "mesh train")
        dp_reduced, dp_gathered = _dp_train_bytes(cfg, MESH_TRAIN_DP)
        depth = f"depth cut to {layers} layers" if layers else "full depth"
        log("mesh-train", f"{arch} {cfg.dtype} full width ({count_params(model_defs(cfg))} "
            f"params), {depth}, B={MESH_TRAIN_B} S={MESH_TRAIN_S}, {steps} AdamW steps "
            f"(tp, ZeRO-1, remat) on the (1, 1) mesh and with mesh=None: losses "
            f"{[round(m['loss'], 4) for m in run['metrics']]} vs "
            f"{[round(m['loss'], 4) for m in plain_metrics]}, grad norms "
            f"{[round(m['grad_norm'], 4) for m in run['metrics']]} vs "
            f"{[round(m['grad_norm'], 4) for m in plain_metrics]}; every param within "
            f"{worst:.3e} of max |x| (bf16 tol {TOL['bfloat16']}); no kernel launched")
        log("mesh-train", f"{arch}: {run['ms']:.2f} ms a step on the mesh vs "
            f"{plain['ms']:.2f} ms with mesh=None (steps 2-{steps}; step 1 "
            f"{run['first_ms']:.2f} vs {plain['first_ms']:.2f}); peak "
            f"{run['peak'] / 2**30:.2f} vs {plain['peak'] / 2**30:.2f} GiB; bytes a step "
            f"on (1, 1): grads reduced {run['reduced']:.0f}, ZeRO-1 gathered "
            f"{run['gathered']:.0f}; a rank of a ({MESH_TRAIN_DP}, 1) mesh would reduce "
            f"{dp_reduced} ({dp_reduced / 2**30:.2f} GiB) and gather {dp_gathered} "
            f"({dp_gathered / 2**30:.2f} GiB) (from the specs)")
        out[arch] = {"ms": run["ms"], "plain_ms": plain["ms"], "peak": run["peak"],
                     "reduced": run["reduced"], "gathered": run["gathered"],
                     "dp_reduced": dp_reduced, "dp_gathered": dp_gathered}
        if arch == MESH_TRAIN_RUNS[0][0]:
            c = _checkpoint_and_serve(cfg, mesh, run)
            out[arch]["ckpt"] = c
            log("mesh-train", f"{arch} checkpoint of the trained state: opt state "
                f"{c['opt_bytes']} bytes saved in {c['opt_save_s']:.2f} s, restored with "
                f"its opt_pspecs in {c['opt_restore_s']:.2f} s; params "
                f"{c['params_bytes']} bytes saved in {c['params_save_s']:.2f} s, "
                f"restored onto the prefill bundle's in_shardings in "
                f"{c['params_restore_s']:.2f} s; both exact")
            log("mesh-train", f"{arch} restored params served, B={MESH_BATCH}, "
                f"{MESH_PROMPT}-token prompts, {DECODE_STEPS} greedy steps: tokens equal "
                f"to mesh=None's (first row {c['first_tokens']}...), logits max_abs_err "
                f"{c['logits_err']:.3e}, launches "
                f"{c['launches']} on both; prefill {c['prefill_ms']:.2f} vs "
                f"{c['plain_prefill_ms']:.2f} ms, step {c['step_ms']:.2f} vs "
                f"{c['plain_step_ms']:.2f} ms")
        del run
        torch.cuda.empty_cache()
        log("mesh-train", f"{arch} took {time.perf_counter() - t0:.1f}s with init")
    return out


def _moe_reduce_bytes(cfg, b: int, s: int, model: int) -> float:
    """Bytes one rank of a (1, ``model``) mesh sends into the MoE's reduction
    over "model" in one forward of B x S tokens, from the specs: where the
    rules put the experts over "model", each MoE layer's f32 combine (B, S,
    d) is a ``Partial`` sum reduced once (``models/moe._dispatch_on_mesh``);
    0 where the expert dim stays whole."""
    from repro_torch import sharding as SH
    from repro_torch.models.moe import moe_defs

    mesh = {"data": 1, "model": model}
    w1 = moe_defs(cfg)["w1"]
    spec = SH.spec_for(w1.shape, w1.axes, SH.make_rules(mesh, "tp"), mesh)
    return float(cfg.n_layers * b * s * cfg.d_model * 4) if spec[0] == "model" else 0.0


def phase_mesh_families(mesh) -> dict:
    """Phase 13: the moe, vlm, encdec and ssm families on the (1, 1) NCCL mesh
    (see the module docstring): (a) prefill and decode through the mesh
    bundles against ``mesh=None``, (b) granite-moe's train step, (c) K1 and
    K2 at the new families' local heads."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.steps import init_model

    out = {}
    for arch, layers, prompt, m_len in MESH_FAMILY_RUNS:
        t0 = time.perf_counter()
        cfg = get_config(arch, attention_impl="pallas")
        cfg = dataclasses.replace(cfg, n_layers=layers,
                                  **({"n_enc_layers": layers} if cfg.n_enc_layers else {}))
        steps = DECODE_STEPS
        _, params = init_model(cfg, seed=0, max_seq=m_len, device="cuda")
        g = torch.Generator(device="cuda").manual_seed(11)
        tokens = torch.randint(1, cfg.vocab, (MESH_BATCH, prompt), generator=g,
                               device="cuda", dtype=torch.int32)
        batch = stub_inputs(cfg, tokens)
        plain = _mesh_run(arch, cfg, None, params, batch, steps, m_len)
        sharded = _mesh_run(arch, cfg, mesh, params, batch, steps, m_len)
        want = dict.fromkeys(ops.KERNELS, 0)
        if cfg.family != "ssm":
            want.update(flash_attention=cfg.n_layers, decode_attention=cfg.n_layers * steps)
        for name, run in (("mesh=None", plain), ("mesh", sharded)):
            if run["launches"] != want:
                raise AssertionError(f"mesh family {arch} {name}: launches "
                                     f"{run['launches']}, want {want}")
        if not torch.equal(sharded["tokens"], plain["tokens"]):
            raise AssertionError(f"mesh family {arch}: greedy tokens differ from mesh=None's")
        if not bool(torch.isfinite(plain["logits"]).all()):
            raise AssertionError(f"mesh family {arch}: non-finite logits")
        err = check_close(f"mesh family {arch} logits", sharded["logits"], plain["logits"],
                          "bfloat16")
        rows = {"vlm": f"{cfg.n_img_tokens} stub image rows + ",
                "encdec": f"{cfg.enc_frames} stub frames, "}.get(cfg.family, "")
        log("mesh-families", f"{arch} bf16 full width, {layers} layers"
            f"{' (and encoder)' if cfg.n_enc_layers else ''}, B={MESH_BATCH}, {rows}{prompt}"
            f"-token prompts, cache {m_len}, {steps} greedy steps: tokens equal to "
            f"mesh=None's (first row {sharded['tokens'][0, :8].tolist()}...), logits "
            f"max_abs_err {err:.3e}; launches {sharded['launches']} on both")
        log("mesh-families", f"{arch}: prefill {sharded['prefill_ms']:.2f} ms on the mesh vs "
            f"{plain['prefill_ms']:.2f} ms with mesh=None; decode step "
            f"{sharded['step_ms']:.2f} ms vs {plain['step_ms']:.2f} ms "
            f"(x{sharded['step_ms'] / plain['step_ms']:.2f}); peak "
            f"{sharded['peak'] / 2**30:.2f} vs {plain['peak'] / 2**30:.2f} GiB; "
            f"{time.perf_counter() - t0:.1f}s with init")
        keep = ("logits", "fed") if arch == EP_ARCH else ()  # phase 15's yardstick
        out[arch] = {k: v for k, v in sharded.items() if k not in ("logits", "tokens", "fed")
                     or k in keep}
        out[arch]["plain"] = {k: plain[k] for k in ("prefill_ms", "step_ms", "peak")}
        del params, plain, sharded, batch
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    arch, layers, steps = MESH_FAMILY_TRAIN
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    run, plain, plain_metrics, worst = _train_pair(arch, cfg, mesh, steps, "mesh family train")
    moe_bytes = _moe_reduce_bytes(cfg, MESH_TRAIN_B, MESH_TRAIN_S, MESH_MOE_MODEL)
    log("mesh-families", f"{arch} {cfg.dtype} full width, {layers} layers, B={MESH_TRAIN_B} "
        f"S={MESH_TRAIN_S}, {steps} AdamW steps (tp, ZeRO-1, remat) on the (1, 1) mesh and "
        f"with mesh=None: losses {[round(m['loss'], 4) for m in run['metrics']]} vs "
        f"{[round(m['loss'], 4) for m in plain_metrics]}, aux "
        f"{[round(m['aux'], 4) for m in run['metrics']]} vs "
        f"{[round(m['aux'], 4) for m in plain_metrics]}, grad norms "
        f"{[round(m['grad_norm'], 4) for m in run['metrics']]} vs "
        f"{[round(m['grad_norm'], 4) for m in plain_metrics]}; every param within "
        f"{worst:.3e} of max |x| (bf16 tol {TOL['bfloat16']}); no kernel launched")
    log("mesh-families", f"{arch}: {run['ms']:.2f} ms a step on the mesh vs {plain['ms']:.2f} "
        f"ms with mesh=None (step 1 {run['first_ms']:.2f} vs {plain['first_ms']:.2f}); peak "
        f"{run['peak'] / 2**30:.2f} vs {plain['peak'] / 2**30:.2f} GiB; bytes a step on "
        f"(1, 1): reduced {run['reduced']:.0f}, gathered {run['gathered']:.0f}; a rank of a "
        f"(1, {MESH_MOE_MODEL}) mesh would send {moe_bytes:.0f} ({moe_bytes / 2**20:.2f} MiB) "
        f"into the MoE's reduction over \"model\" a forward (from the specs; remat's "
        f"recompute repeats it); {time.perf_counter() - t0:.1f}s with init")
    out["train"] = {"ms": run["ms"], "plain_ms": plain["ms"], "peak": run["peak"],
                    "moe_reduce_bytes": moe_bytes, "metrics": run["metrics"]}
    del run
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    shapes = {arch: (prompt + (get_config(arch).n_img_tokens or 0), m_len)
              for arch, _, prompt, m_len in MESH_FAMILY_RUNS}
    for arch, models in MESH_FAMILY_HEADS:
        cfg = get_config(arch)
        s, m_len = shapes[arch]
        for model in models:
            _hold_local_heads(f"{arch} at model={model}", cfg.n_heads, cfg.n_kv_heads,
                              cfg.resolved_head_dim, model, s, m_len, "mesh-families")
    log("mesh-families", f"local heads took {time.perf_counter() - t0:.1f}s")
    return out


def _ep_cfg(cfg, route: str):
    import dataclasses

    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, routing_impl=route))


def _ep_pipeline_and_compression(mesh) -> str:
    """The pipeline (one stage) against the plain sequential loop, and the
    compressed mean against its definition, on CUDA tensors over the one-rank
    NCCL group: the collectives take them (int8 on the compressed mean's
    wire).  Returns the log line."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.optim.compression import compressed_mean, quantize_int8
    from repro_torch.parallel.pipeline import pipeline_apply

    d, n_layers, b, n_micro = (EP_PIPE[k] for k in ("d", "layers", "b", "n_micro"))
    g = torch.Generator(device="cuda").manual_seed(5)
    ws = torch.randn(n_layers, d, d, generator=g, device="cuda") / math.sqrt(d)
    x = torch.randn(b, d, generator=g, device="cuda")
    pod = init_device_mesh("cuda", (1,), mesh_dim_names=("pod",))
    w = DTensor.from_local(ws[None], pod, [Shard(0)], run_check=False).requires_grad_()
    xd = DTensor.from_local(x, pod, [Replicate()], run_check=False).requires_grad_()

    def stage_fn(params, h):
        for wi in params["w"]:
            h = torch.tanh(h @ wi)
        return h

    out = pipeline_apply(stage_fn, {"w": w}, xd, pod, axis="pod", n_micro=n_micro)
    out.to_local().sum().backward()
    xr, wr = x.clone().requires_grad_(), ws.clone().requires_grad_()
    want = stage_fn({"w": wr}, xr)
    want.sum().backward()
    pipe = [_hold(f"pipeline {what}", _rel(got, ref), TOL["float32"]) for what, got, ref in (
        ("output", out.to_local(), want), ("grad x", xd.grad.to_local(), xr.grad),
        ("grad w", w.grad.to_local()[0], wr.grad))]

    grad = torch.randn(EP_COMP_NUMEL, generator=g, device="cuda")
    err = torch.randn(EP_COMP_NUMEL, generator=g, device="cuda") * 1e-3
    mean, new_err = compressed_mean(grad, err, mesh.get_group("data"))
    corrected = grad + err  # the definition on one rank
    scale = torch.clamp(corrected.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(corrected / scale), -127, 127).to(torch.int8)
    q2, scale2 = quantize_int8(q.float() * scale / 1)
    if not (torch.equal(mean, q2.float() * scale2)
            and torch.equal(new_err, corrected - q.float() * scale)):
        raise AssertionError("compressed_mean on one rank differs from its definition")
    bound = 2 * float(corrected.abs().max()) / 127
    off = max_err(mean, grad)
    if off >= bound:
        raise AssertionError(f"compressed_mean: {off:.3e} from the exact mean, bound {bound:.3e}")
    return (f"pipeline_apply (1 stage, {n_layers} tanh layers d={d}, b={b}, n_micro={n_micro}) "
            f"vs the sequential loop: output, grad x, grad w rel {pipe[0]:.2e}, {pipe[1]:.2e}, "
            f"{pipe[2]:.2e} (tol {TOL['float32']}); compressed_mean of {EP_COMP_NUMEL} f32 "
            f"(int8 all_to_all_single and all_gather over NCCL) equal to its definition, "
            f"{off:.3e} from the exact mean (bound 2 amax/127 = {bound:.3e})")


def phase_mesh_ep(mesh, families: dict, smi: str) -> dict:
    """Phase 15: expert parallelism on the (1, 1) NCCL mesh (see the module
    docstring): (a) f32 parity of both EP routes against "dropping", (b) phase
    13's bf16 run under both routes, (c) phase 13's train step under
    ep_gather, (d) the pipeline and the compressed mean."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.steps import init_model

    out = {}
    t0 = time.perf_counter()
    arch, layers, prompt, m_len = next(r for r in MESH_FAMILY_RUNS if r[0] == EP_ARCH)
    cfg = dataclasses.replace(get_config(arch, attention_impl="pallas", dtype="float32"),
                              n_layers=PARITY_DEPTH)
    _, params = init_model(cfg, seed=0, max_seq=m_len, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(11)
    batch = {"tokens": torch.randint(1, cfg.vocab, (MESH_BATCH, prompt), generator=g,
                                     device="cuda", dtype=torch.int32)}
    want = _mesh_run(arch, cfg, mesh, params, batch, EP_PARITY_STEPS, m_len)
    worst = {}
    for route in EP_ROUTES:
        run = _mesh_run(arch, _ep_cfg(cfg, route), mesh, params, batch, EP_PARITY_STEPS, m_len,
                        feed=want["fed"])
        if run["launches"] != want["launches"]:
            raise AssertionError(f"mesh-ep f32 {route}: launches {run['launches']}, "
                                 f"dropping's {want['launches']}")
        worst[route] = _check_rel(f"mesh-ep f32 {route} logits", run["logits"], want["logits"])
    tcfg = dataclasses.replace(cfg, attention_impl="xla")  # no kernel has a backward
    train = {r: _train_run(_ep_cfg(tcfg, r), mesh, 2)["metrics"][0] for r in ("dropping",
                                                                               "ep_gather")}
    loss_rel = abs(train["ep_gather"]["loss"] - train["dropping"]["loss"]) / abs(
        train["dropping"]["loss"])
    _hold("mesh-ep f32 ep_gather train loss", loss_rel)
    log("mesh-ep", f"{arch} f32 full width, {PARITY_DEPTH} layer, B={MESH_BATCH}, {prompt}-token "
        f"prompts + {EP_PARITY_STEPS} steps fed the dropping run's tokens, on the (1, 1) mesh: "
        f"logits err / max |logit| " + ", ".join(f"{r} {v:.3e}" for r, v in worst.items())
        + f" (tol {PARITY_REL_TOL}); launches {want['launches']} on every route; one train "
        f"step (B={MESH_TRAIN_B} S={MESH_TRAIN_S}): loss {train['ep_gather']['loss']:.6f} under "
        f"ep_gather vs {train['dropping']['loss']:.6f} (rel {loss_rel:.2e}, tol "
        f"{PARITY_REL_TOL}); {time.perf_counter() - t0:.1f}s with init")
    del params
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    base = dataclasses.replace(get_config(arch, attention_impl="pallas"), n_layers=layers)
    _, params = init_model(base, seed=0, max_seq=m_len, device="cuda")  # phase 13's
    g = torch.Generator(device="cuda").manual_seed(11)
    batch = {"tokens": torch.randint(1, base.vocab, (MESH_BATCH, prompt), generator=g,
                                     device="cuda", dtype=torch.int32)}
    drop = families[arch]
    k_want = dict.fromkeys(ops.KERNELS, 0)
    k_want.update(flash_attention=layers, decode_attention=layers * DECODE_STEPS)
    # the control: dropping again with the model's input nudged at f32
    # rounding, which flips bf16 roundings as an f32 sum's order does; a
    # route may drift CHAOS_FACTOR x as far
    control = _mesh_run(arch, base, mesh, _nudged(params), batch, DECODE_STEPS, m_len,
                        feed=drop["fed"])
    dc = _rel(control["logits"], drop["logits"])
    for route in EP_ROUTES:
        run = _mesh_run(arch, _ep_cfg(base, route), mesh, params, batch, DECODE_STEPS, m_len,
                        feed=drop["fed"])
        if run["launches"] != k_want or drop["launches"] != k_want:
            raise AssertionError(f"mesh-ep {route}: launches {run['launches']}, dropping's "
                                 f"{drop['launches']}, want {k_want}")
        rel = _hold(f"mesh-ep bf16 {route} logits", _rel(run["logits"], drop["logits"]),
                    max(CHAOS_FACTOR * dc, PARITY_REL_TOL))
        agree = float((run["tokens"][:, :-1] == drop["fed"][:, 1:]).float().mean())
        log("mesh-ep", f"{arch} bf16 full width, {layers} layers, B={MESH_BATCH}, {prompt}-token "
            f"prompts, {DECODE_STEPS} steps fed phase 13's dropping tokens, under {route}: "
            f"logits err / max |logit| {rel:.3e}, the control's {dc:.3e} (within "
            f"{CHAOS_FACTOR} x); greedy tokens equal "
            f"to dropping's at {agree:.4f} of the steps; launches {run['launches']} as "
            f"dropping's; prefill {run['prefill_ms']:.2f} ms vs {drop['prefill_ms']:.2f}, "
            f"decode step {run['step_ms']:.2f} ms vs {drop['step_ms']:.2f}; peak "
            f"{run['peak'] / 2**30:.2f} GiB ({smi})")
        out[route] = {k: run[k] for k in ("prefill_ms", "step_ms", "peak")}
        del run
    del params
    torch.cuda.empty_cache()
    log("mesh-ep", f"bf16 runs took {time.perf_counter() - t0:.1f}s with init")

    t0 = time.perf_counter()
    tarch, tlayers, tsteps = MESH_FAMILY_TRAIN
    tcfg = _ep_cfg(dataclasses.replace(get_config(tarch), n_layers=tlayers), "ep_gather")
    run = _train_run(tcfg, mesh, tsteps)
    ref = families["train"]["metrics"]
    for i, (m, w) in enumerate(zip(run["metrics"][:1], ref)):
        for k in ("loss", "aux"):
            if abs(m[k] - w[k]) > TOL["bfloat16"] * abs(w[k]):
                raise AssertionError(f"mesh-ep train {k}: {m[k]} under ep_gather, {w[k]} "
                                     "under dropping")
    log("mesh-ep", f"{tarch} bf16 full width, {tlayers} layers, B={MESH_TRAIN_B} "
        f"S={MESH_TRAIN_S}, {tsteps} AdamW steps under ep_gather on the (1, 1) mesh: step-1 "
        f"loss {run['metrics'][0]['loss']:.5f} vs dropping's {ref[0]['loss']:.5f}, aux "
        f"{run['metrics'][0]['aux']:.5f} vs {ref[0]['aux']:.5f} (tol {TOL['bfloat16']}); "
        f"{run['ms']:.2f} ms a step vs dropping's {families['train']['ms']:.2f} ms (step 1 "
        f"{run['first_ms']:.2f}); peak {run['peak'] / 2**30:.2f} GiB; "
        f"{time.perf_counter() - t0:.1f}s with init ({smi})")
    out["train"] = {"ms": run["ms"], "first_ms": run["first_ms"], "peak": run["peak"]}
    del run
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    log("mesh-ep", _ep_pipeline_and_compression(mesh)
        + f"; {time.perf_counter() - t0:.1f}s")
    return out


def _coll_line(coll: dict) -> str:
    return ", ".join(f"{k} {n} x ({coll['operand_bytes'][k] / 2**20:.2f} MiB operand, "
                     f"{coll['wire_bytes'][k] / 2**20:.2f} MiB wire)"
                     for k, n in sorted(coll["counts"].items())) or "none"


def phase_mesh_dryrun(mesh, dryrun: "_Dryrun", mesh_out: dict) -> dict:
    """Phase 14: phase 11's gemma-2b bundle (MESH_DENSE_LAYERS layers, K1/K2)
    on the (1, 1) NCCL mesh under ``StepCost(device="cuda")`` against the
    dry-run's count of it on a fake (1, 1) group (``start_mesh_dryrun``):
    a MESH_PROMPT-token prefill, then one decode step on a cache of
    MESH_DRYRUN_SLOTS slots, each after ``reset_peak_memory_stats``.  FLOPs,
    bytes, kernel calls and collectives equal the fake count; the peak
    within PEAK_REL_TOL of ``max_memory_allocated``; K1 and K2 launches
    those of phase 11's prefill and of one of its steps.  Then the
    process's full-width counts of MESH_DRYRUN_CELL on 16 x 16 and 2 x 16 x
    16 (per-device peak, hbm_fit, collectives, count time), logged only."""
    import dataclasses

    import torch

    from repro_torch import sharding as SH
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.analysis import StepCost
    from repro_torch.models import decoding as DEC
    from repro_torch.steps import init_model, make_decode_step, make_prefill_step

    rec = dryrun.result()
    cfg = dataclasses.replace(get_config("gemma-2b", attention_impl="pallas"),
                              n_layers=MESH_DENSE_LAYERS)
    b, slots = MESH_BATCH, MESH_DRYRUN_SLOTS
    pre = make_prefill_step(cfg, mesh, ShapeConfig("prefill", MESH_PROMPT, b, "prefill"))
    dec = make_decode_step(cfg, mesh, ShapeConfig("decode", slots, b, "decode"))
    phase11 = mesh_out["gemma-2b"]["launches"]
    want = {"prefill": dict(dict.fromkeys(ops.KERNELS, 0),
                            flash_attention=phase11["flash_attention"]),
            "decode": dict(dict.fromkeys(ops.KERNELS, 0),
                           decode_attention=phase11["decode_attention"] // DECODE_STEPS)}
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    _, params = init_model(cfg, seed=0, max_seq=slots, device="cuda")
    params = SH.distribute(params, mesh, pre.in_shardings[0])
    g = torch.Generator(device="cuda").manual_seed(14)

    def tokens(s):
        return torch.randint(1, cfg.vocab, (b, s), generator=g, device="cuda",
                             dtype=torch.int32)

    def prefill_inputs():
        return {"params": params,
                "batch": SH.distribute({"tokens": tokens(MESH_PROMPT)}, mesh,
                                       pre.in_shardings[1])}

    def decode_inputs():
        return {"params": params,
                "cache": DEC.init_cache(cfg, b, slots, device="cuda", mesh=mesh),
                "batch": SH.distribute({"tokens": tokens(1)}, mesh, dec.in_shardings[2])}

    out = {}
    for kind, bundle, make in (("prefill", pre, prefill_inputs), ("decode", dec, decode_inputs)):
        fake, inputs = rec[kind], make()
        ops.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with StepCost(inputs, device="cuda") as cost:
            res = bundle.fn(**inputs)
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() - base
        logits = res[0]
        if not bool(torch.isfinite(logits).all()) or tuple(logits.shape)[0] != b:
            raise AssertionError(f"mesh-dryrun {kind}: logits {tuple(logits.shape)}, finite "
                                 f"{bool(torch.isfinite(logits).all())}")
        del res, logits, inputs
        card = {"flops": cost.flops, "bytes": cost.total_bytes,
                "input_bytes": cost.input_bytes, "kernel_calls": cost.kernel_calls,
                "collectives": cost.collectives()}
        for key, got in card.items():
            if got != fake[key]:
                raise AssertionError(f"mesh-dryrun {kind}: {key} on the card {got} != the fake "
                                     f"(1, 1) count's {fake[key]}")
        if ops.launches() != want[kind]:
            raise AssertionError(f"mesh-dryrun {kind}: launches {ops.launches()}, want "
                                 f"{want[kind]} (phase 11's)")
        rel = _peak_check(f"mesh-dryrun {kind}", fake["peak"], peak)
        out[kind] = {"peak_predicted": fake["peak"], "peak_measured": peak, "peak_rel": rel,
                     "flops": cost.flops, "bytes": cost.total_bytes, "wall_ms": wall_ms,
                     "launches": ops.launches(), "count_s": fake["count_s"]}
        log("mesh-dryrun", f"gemma-2b {MESH_DENSE_LAYERS} layers bf16 B={b} {kind} "
            f"({MESH_PROMPT if kind == 'prefill' else slots} "
            f"{'tokens' if kind == 'prefill' else 'cache slots, one step'}) on the (1, 1) NCCL "
            f"mesh: FLOPs {cost.flops:.6e}, bytes {cost.total_bytes:.6e}, inputs "
            f"{cost.input_bytes / 2**30:.3f} GiB, kernel calls {cost.kernel_calls}, "
            f"collectives {_coll_line(card['collectives'])}: equal to the fake (1, 1) count "
            f"(counted in {fake['count_s']:.2f} s on the CPU); peak {fake['peak'] / 2**30:.3f} "
            f"GiB predicted vs max_memory_allocated {peak / 2**30:.3f} GiB ({rel:+.2%}, tol "
            f"{PEAK_REL_TOL:.0%}); launches {ops.launches()} as phase 11's; {wall_ms:.2f} ms "
            f"under the counter")
    del params
    torch.cuda.empty_cache()
    for name in ("16x16", "2x16x16"):
        r = rec[name]
        log("mesh-dryrun", f"{MESH_DRYRUN_CELL[0]} {MESH_DRYRUN_CELL[1]} at full width on "
            f"{name} ({r['n_chips']} devices, counted on {r['accounting']['counted_on']}), "
            f"CPU count on meta: per-device peak "
            f"{r['memory']['peak_bytes_per_device'] / 2**30:.3f} GiB, hbm_fit {r['hbm_fit']}, "
            f"FLOPs/dev {r['flops_per_dev']:.4e}, collectives {_coll_line(r['collectives'])}; "
            f"counted in {r['count_s']:.2f} s")
        out[name] = r
    return out


def _bound(flops: float, nbytes: float, peak: float, exp_rate: float, exps: float = 0) -> dict:
    """The roofline bound of a kernel call in ms: the larger of its bytes
    over the card's memory rate and its operations over their peak, FLOPs at
    their type's ``peak`` or exps on the SFU at ``exp_rate``, the longer."""
    t = {"bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3, "flops_ms": flops / peak * 1e3,
         "exps_ms": exps / exp_rate * 1e3}
    t_ops = max(t["flops_ms"], t["exps_ms"])
    return {"bound_ms": max(t["bytes_ms"], t_ops), "bytes": nbytes, "flops": flops,
            "bound_by": "bytes" if t["bytes_ms"] >= t_ops else "operations", **t}


def main() -> int:
    t_start = time.perf_counter()
    smi = phase_device()
    procs = [start_mesh_dryrun()]  # on the CPU beside the build
    try:
        phase_build()
        procs.append(start_dryrun())
        return _phases(t_start, smi, procs[1], procs[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


class _Dryrun:
    """The dry-run process's records, read once."""

    def __init__(self, proc):
        self.proc, self.records = proc, None

    def result(self) -> dict:
        if self.records is None:
            out, err = self.proc.communicate(timeout=600)
            if self.proc.returncode != 0:
                raise AssertionError(f"the dry-run process failed:\n{err[-3000:]}")
            self.records = json.loads([ln for ln in out.splitlines()
                                       if ln.startswith("RESULT ")][0][7:])
        return self.records


def _phases(t_start: float, smi: str, proc, mesh_proc) -> int:
    import torch

    fresh = phase_fresh()
    t0 = time.perf_counter()
    worst = phase_kernels()
    log("kernels", f"phase took {time.perf_counter() - t0:.1f}s")
    for arch, depth in PARITY_RUNS:
        t0 = time.perf_counter()
        phase_parity(arch, depth)
        log("parity", f"{arch} took {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_xlstm_parity()
    log("parity", f"{XLSTM_PARITY[0]} took {time.perf_counter() - t0:.1f}s")
    serves = {}
    for label, args in SERVE_RUNS:
        t0 = time.perf_counter()
        serves[label] = phase_serve(label, args)
        log("serve", f"{label} took {time.perf_counter() - t0:.1f}s with init")
    for arch, b, prompt, max_len in DECODE_RUNS:
        t0 = time.perf_counter()
        serves[f"decode {arch}"] = phase_decode(arch, b, prompt, max_len)
        log("decode", f"{arch} took {time.perf_counter() - t0:.1f}s with init")
    t0 = time.perf_counter()
    serves[f"window {WINDOW_RUN[0]}"] = phase_window(*WINDOW_RUN)
    log("window", f"{WINDOW_RUN[0]} took {time.perf_counter() - t0:.1f}s with init")
    t0 = time.perf_counter()
    kernels = phase_timing(worst, serves, fresh)
    log("timing", f"phase took {time.perf_counter() - t0:.1f}s")
    for arch in BREAKDOWN_ARCHS:
        phase_breakdown(arch)
    phase_train()
    t0 = time.perf_counter()
    phase_bridge(serves["gemma-2b"])
    log("bridge", f"phase took {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_cells(_Dryrun(proc), kernels)
    log("cells", f"phase took {time.perf_counter() - t0:.1f}s")
    with mesh_group() as mesh:
        t0 = time.perf_counter()
        mesh_out = phase_mesh(mesh)
        log("mesh", f"phase took {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        phase_mesh_train(mesh)
        log("mesh-train", f"phase took {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        families = phase_mesh_families(mesh)
        log("mesh-families", f"phase took {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        phase_mesh_ep(mesh, families, smi)
        log("mesh-ep", f"phase took {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        phase_mesh_dryrun(mesh, _Dryrun(mesh_proc), mesh_out)
        log("mesh-dryrun", f"phase took {time.perf_counter() - t0:.1f}s")
    log("done", f"all phases passed in {time.perf_counter() - t_start:.1f}s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
