"""Model initialisation for serving (port of ``repro.steps.init_model``), and
the device rule every entry point follows: the card unless the caller asks
for the CPU, and an error, never a quiet CPU run, when there is no card."""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as TF
from repro_torch.models.params import init_params


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available; "
                           "pass device='cpu' (--device cpu) to run on the CPU")
    return dev


def init_model(cfg: ModelConfig, seed: int = 0, max_seq: int = 128,
               device="cuda") -> Tuple[Any, Any]:
    """(defs, params) with params drawn on ``device`` from a generator seeded
    with ``seed``.  ``max_seq`` is the reference's argument; it sizes position
    tables, which the dense (rope) family does not have."""
    dev = resolve_device(device)
    defs = TF.model_defs(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return defs, init_params(defs, gen, dev)
