"""Model assembly for the dense decoder family.

Port of the dense part of ``repro.models.transformer``: pre-norm attention +
MLP blocks whose per-layer params are stacked on a leading L dim.  A Python
loop over that dim replaces ``lax.scan``.  The other families (moe, hybrid,
ssm, encdec, vlm) are not ported yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.params import ParamDef, tree_map

Params = Dict[str, Any]

PORTED_FAMILIES = ("dense",)


def check_family(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported to repro_torch yet; "
            f"ported: {PORTED_FAMILIES}")


def stack_defs(defs: Any, n: int) -> Any:
    return tree_map(
        lambda d: ParamDef((n,) + d.shape, ("layers",) + d.axes, d.init, d.scale, d.dtype), defs)


def block_defs(cfg: ModelConfig) -> Params:
    check_family(cfg)
    return {"ln_attn": L.norm_defs(cfg), "attn": L.attention_defs(cfg),
            "ln_mlp": L.norm_defs(cfg), "mlp": L.mlp_defs(cfg)}


def model_defs(cfg: ModelConfig) -> Params:
    """Full parameter tree; the blocks are stacked on a leading L dim (the
    dense archs all use ``layer_impl="scan"``)."""
    check_family(cfg)
    if cfg.layer_impl != "scan":
        raise NotImplementedError(f"layer_impl={cfg.layer_impl!r}: the port stacks layers")
    return {"embed": L.embed_defs(cfg), "ln_f": L.norm_defs(cfg),
            "blocks": stack_defs(block_defs(cfg), cfg.n_layers)}


def layer_params(blocks: Params, i: int) -> Params:
    """Layer i's params from the stacked blocks."""
    return tree_map(lambda t: t[i], blocks)


def _apply_block(p: Params, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One decoder block.  Returns (x, (k, v))."""
    xn = L.apply_norm(p["ln_attn"], x, cfg.norm)
    attn_out, (k, v) = L.attn_forward(p["attn"], xn, positions, cfg)
    x = x + attn_out
    xn2 = L.apply_norm(p["ln_mlp"], x, cfg.norm)
    x = x + L.apply_mlp(p["mlp"], xn2, cfg.activation)
    return x, (k, v)


def _embed_inputs(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (x, positions, tokens)."""
    check_family(cfg)
    tokens = batch["tokens"]
    x = L.embed_tokens(params["embed"], tokens, cfg)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    return x, positions, tokens
