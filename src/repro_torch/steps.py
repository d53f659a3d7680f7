"""Model initialisation (port of ``repro.steps.init_model``), the train step
(``make_train_step``), and the device rule every entry point follows: the
card unless the caller asks for the CPU, and an error, never a quiet CPU
run, when there is no card.

The reference's train step is a pjit bundle with shardings, ZeRO-1 and a
``strategy``; the port's runs on one device and takes none of those until
distribution is ported.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as TF
from repro_torch.models.params import init_params, tree_map, tree_paths
from repro_torch.optim.adamw import AdamWConfig, adamw_update


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available; "
                           "pass device='cpu' (--device cpu) to run on the CPU")
    return dev


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


def make_train_step(cfg: ModelConfig, opt_cfg: Optional[AdamWConfig] = None,
                    remat: bool = True) -> Callable:
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``:
    forward, backward, then ``adamw_update`` under ``torch.no_grad()``.

    Params become leaves that require grad; they and the moments are updated
    in place, and their grads are read and cleared.  ``metrics`` holds the
    0-d tensors loss, aux, grad_norm and lr.  A param left without a
    gradient raises rather than skipping its update."""
    opt_cfg = opt_cfg or AdamWConfig()

    def step(params, opt_state, batch: Dict[str, torch.Tensor]):
        named = tree_paths(params)
        for _, p in named:
            p.requires_grad_(True)
        with torch.enable_grad():
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
        return params, opt_state, {**{k: v.detach() for k, v in metrics.items()},
                                   **opt_metrics}

    return step
