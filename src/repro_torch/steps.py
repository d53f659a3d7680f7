"""The steps (port of ``repro.steps``): model initialisation, the train
step, and a ``StepBundle`` for every (arch x shape) cell, plus the device
rule every entry point follows: the card unless the caller asks for the
CPU, and an error, never a quiet CPU run, when there is no card.

A bundle's ``input_specs`` are ``meta`` tensors (shapes and dtypes, no
storage), the stand-ins of the reference's ``ShapeDtypeStruct``s: calling
``fn(**input_specs)`` runs the step on ``meta``, which is what the dry-run
does (``launch/dryrun.py``).

The builders take the reference's ``(cfg, mesh, shape, strategy)``.
``mesh=None`` is one device: plain tensors, no shardings.  On a mesh (a
``DeviceMesh`` with axes "data" and "model", ``launch/mesh.py``) the
prefill and decode bundles carry the reference's ``in_shardings`` /
``out_shardings`` as trees of ``sharding.P``; ``fn`` takes DTensors placed
by ``in_shardings`` (``sharding.distribute``) and raises for any other
placement, returns the logits as a full tensor and the cache with
``out_shardings``' placements, and runs with the mesh installed
(``parallel.ep.ep_mesh``).  The train bundle takes params and the
optimizer state placed by ``in_shardings`` (the moments by
``optim.adamw.opt_pspecs``, ZeRO-1 by default) and the batch over the
data-parallel axes, and returns them placed by ``out_shardings``, with its
0-d metrics as full tensors.  Every family runs on a mesh, the production
mesh (``launch/mesh.py::make_production_mesh``) included, where the dry-run
counts a step as one rank of a fake group sees it (``launch/dryrun.py``),
and the installed mesh carries the expert-parallel MoE routes
(``parallel/ep.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch import sharding as SH
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import decoding as DEC
from repro_torch.models import transformer as TF
from repro_torch.models.layers import adtype
from repro_torch.models.params import abstract_params, init_params, tree_map, tree_paths
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update, opt_pspecs
from repro_torch.parallel.ep import ep_mesh


@dataclasses.dataclass(frozen=True)
class StepBundle:
    """One cell's step: ``fn(**input_specs)`` runs it.  ``in_shardings`` /
    ``out_shardings`` are the specs of ``fn``'s arguments and results (None
    without a mesh, and for the full logits).  ``donate_argnames`` are the
    inputs the step overwrites in place (the reference donates them)."""
    fn: Callable
    input_specs: Dict[str, Any]
    in_shardings: Any = None
    out_shardings: Any = None
    donate_argnames: Tuple[str, ...] = ()


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available; "
                           "pass device='cpu' (--device cpu) to run on the CPU")
    return dev


def _spec(shape: Tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """The model inputs of a cell (no params, optimizer state or cache) as
    ``meta`` tensors: tokens (and targets and mask for ``train``) of B x S
    minus the vlm's image rows, the stub frontend's ``img_embeds`` (vlm) or
    ``enc_frames`` (encdec); one token a row for ``decode``."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind not in ("train", "prefill"):
        return {"tokens": _spec((b, 1), torch.int32)}
    s_text = s - (cfg.n_img_tokens if cfg.family == "vlm" else 0)
    specs = {"tokens": _spec((b, s_text), torch.int32)}
    if cfg.family == "vlm":
        specs["img_embeds"] = _spec((b, cfg.n_img_tokens, cfg.d_model), adtype(cfg))
    if cfg.family == "encdec":
        specs["enc_frames"] = _spec((b, cfg.enc_frames, cfg.d_model), adtype(cfg))
    if shape.kind == "train":
        specs["targets"] = _spec((b, s_text), torch.int32)
        specs["mask"] = _spec((b, s_text), torch.float32)
    return specs


def make_synthetic_batch(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0,
                         device="cuda") -> Dict[str, torch.Tensor]:
    """A random batch matching ``batch_specs`` on ``device``, drawn from a
    generator seeded with ``seed``: ints uniform in [0, vocab), the mask all
    ones, embeddings standard normal in f32 cast to their dtype."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    out = {}
    for key, spec in batch_specs(cfg, shape).items():
        if spec.dtype == torch.int32:
            out[key] = torch.randint(0, cfg.vocab, spec.shape, generator=gen, device=dev,
                                     dtype=torch.int32)
        elif key == "mask":
            out[key] = torch.ones(spec.shape, dtype=spec.dtype, device=dev)
        else:
            out[key] = torch.randn(spec.shape, generator=gen, device=dev).to(spec.dtype)
    return out


def decode_window(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """The sliding window a decode cell runs with: ``cfg.long_window`` on the
    ``long_500k`` shape where the arch has one, else 0 (reference
    steps.py:155)."""
    return cfg.long_window if (shape.name == "long_500k" and cfg.long_window) else 0


def _specs(cfg: ModelConfig, mesh, shape: ShapeConfig, strategy: str, window: int = 0
           ) -> Tuple[Any, Any, Any]:
    """(param, batch, cache) specs of a cell on ``mesh`` (reference
    steps.py:131-137 and :156-162)."""
    defs = TF.model_defs(cfg, max_seq=shape.seq_len)
    return (SH.param_pspecs(defs, SH.make_rules(mesh, strategy), mesh),
            SH.batch_pspecs(batch_specs(cfg, shape), mesh),
            SH.cache_pspecs(cfg, DEC.cache_specs(cfg, shape.global_batch, shape.seq_len,
                                                 window), mesh))


def _full(logits: torch.Tensor) -> torch.Tensor:
    return logits.full_tensor() if isinstance(logits, DTensor) else logits


def make_prefill_step(cfg: ModelConfig, mesh, shape: ShapeConfig,
                      strategy: str = "tp") -> StepBundle:
    """``fn(params, batch) -> (last-token logits, cache of seq_len)``, under
    ``no_grad``; on a mesh see the module docstring."""
    defs = TF.model_defs(cfg, max_seq=shape.seq_len)
    ins = outs = None
    if mesh is not None:
        p_specs, b_specs, c_specs = _specs(cfg, mesh, shape, strategy)
        ins, outs = (p_specs, b_specs), (None, c_specs)

    @torch.no_grad()
    def prefill_step(params, batch):
        if mesh is not None:
            SH.check_placed(params, mesh, ins[0], "prefill params")
            SH.check_placed(batch, mesh, ins[1], "prefill batch")
        with ep_mesh(mesh):
            logits, cache = DEC.prefill(params, cfg, batch, max_len=shape.seq_len)
        return _full(logits), cache

    return StepBundle(fn=prefill_step, in_shardings=ins, out_shardings=outs,
                      input_specs={"params": abstract_params(defs),
                                   "batch": batch_specs(cfg, shape)})


def make_decode_step(cfg: ModelConfig, mesh, shape: ShapeConfig,
                     strategy: str = "tp") -> StepBundle:
    """``fn(params, cache, batch) -> (logits, cache)``: one token a row
    against a cache of seq_len slots (``decode_window`` of them on
    ``long_500k``), written in place, under ``no_grad``; on a mesh see the
    module docstring."""
    window = decode_window(cfg, shape)
    defs = TF.model_defs(cfg, max_seq=shape.seq_len)
    ins = outs = None
    if mesh is not None:
        p_specs, b_specs, c_specs = _specs(cfg, mesh, shape, strategy, window)
        ins, outs = (p_specs, c_specs, b_specs), (None, c_specs)

    @torch.no_grad()
    def decode_step(params, cache, batch):
        if mesh is not None:
            for tree, spec, what in zip((params, cache, batch), ins, ("params", "cache",
                                                                       "batch")):
                SH.check_placed(tree, mesh, spec, f"decode {what}")
        with ep_mesh(mesh):
            logits, cache = DEC.decode_step(params, cfg, cache, batch["tokens"],
                                            window=window)
        return _full(logits), cache

    return StepBundle(
        fn=decode_step, in_shardings=ins, out_shardings=outs,
        input_specs={"params": abstract_params(defs),
                     "cache": DEC.cache_specs(cfg, shape.global_batch, shape.seq_len, window),
                     "batch": batch_specs(cfg, shape)},
        donate_argnames=("cache",))


def make_step(cfg: ModelConfig, mesh, shape: ShapeConfig,
              opt_cfg: Optional[AdamWConfig] = None, strategy: str = "tp") -> StepBundle:
    """The bundle of a cell of ``shape.kind``: ``train`` is
    ``make_train_step(cfg, mesh, shape, opt_cfg, strategy)`` (ZeRO-1 and
    remat on, the reference's defaults).  The other kinds ignore
    ``opt_cfg``."""
    if shape.kind == "prefill":
        return make_prefill_step(cfg, mesh, shape, strategy)
    if shape.kind == "decode":
        return make_decode_step(cfg, mesh, shape, strategy)
    return make_train_step(cfg, mesh, shape, opt_cfg, strategy)


def init_model(cfg: ModelConfig, seed: int = 0, max_seq: int = 128,
               device="cuda") -> Tuple[Any, Any]:
    """(defs, params) with params drawn on ``device`` from a generator seeded
    with ``seed``.  ``max_seq`` sizes the absolute position tables (encdec's
    decoder), as in the reference; the rope families have none."""
    dev = resolve_device(device)
    defs = TF.model_defs(cfg, max_seq=max_seq)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return defs, init_params(defs, gen, dev)


def make_train_step(cfg: ModelConfig, mesh, shape: ShapeConfig,
                    opt_cfg: Optional[AdamWConfig] = None, strategy: str = "tp",
                    zero1: bool = True, remat: bool = True) -> StepBundle:
    """``fn(params, opt_state, batch) -> (params, opt_state, metrics)``:
    forward, backward, then ``adamw_update`` under ``torch.no_grad()``
    (reference steps.py:85).

    Params become leaves that require grad; they and the moments are updated
    in place, and their grads are read and cleared.  ``metrics`` holds the
    0-d tensors loss, aux, grad_norm and lr.  A param left without a
    gradient raises rather than skipping its update.  On a mesh ``fn``
    refuses inputs placed otherwise than ``in_shardings`` = (param specs,
    ``opt_pspecs(..., zero1)``, batch specs) and returns the params and the
    state placed by ``out_shardings`` and the metrics as full tensors; see
    ``optim/adamw.py`` for the grads' reduction and ZeRO-1.  ``shape`` sizes
    ``input_specs`` (and the batch's specs)."""
    opt_cfg = opt_cfg or AdamWConfig()
    defs = TF.model_defs(cfg, max_seq=shape.seq_len)
    ins = outs = None
    if mesh is not None:
        rules = SH.make_rules(mesh, strategy)
        p_specs = SH.param_pspecs(defs, rules, mesh)
        o_specs = opt_pspecs(defs, rules, mesh, zero1=zero1)
        ins = (p_specs, o_specs, SH.batch_pspecs(batch_specs(cfg, shape), mesh))
        outs = (p_specs, o_specs, None)

    def train_step(params, opt_state, batch: Dict[str, torch.Tensor]):
        if mesh is not None:
            for tree, spec, what in zip((params, opt_state, batch), ins,
                                        ("params", "opt_state", "batch")):
                SH.check_placed(tree, mesh, spec, f"train {what}")
        named = tree_paths(params)
        for _, p in named:
            p.requires_grad_(True)
        with ep_mesh(mesh), torch.enable_grad():
            total, metrics = TF.forward_train(params, cfg, batch, remat=remat)
            total.backward()
        missing = [path for path, p in named if p.grad is None]
        if missing:
            raise RuntimeError(f"no gradient reached {missing}")
        with torch.no_grad():
            params, opt_state, opt_metrics = adamw_update(
                tree_map(lambda p: p.grad, params), opt_state, params, opt_cfg)
        for _, p in named:
            p.grad = None
        return params, opt_state, {k: _full(v.detach())
                                   for k, v in {**metrics, **opt_metrics}.items()}

    abs_params = abstract_params(defs)
    return StepBundle(
        fn=train_step, in_shardings=ins, out_shardings=outs,
        input_specs={"params": abs_params, "opt_state": adamw_init(abs_params),
                     "batch": batch_specs(cfg, shape)},
        donate_argnames=("params", "opt_state"))
