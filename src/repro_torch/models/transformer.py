"""Model assembly for the dense, hybrid and moe decoder families.

Port of the dense, hybrid and moe parts of ``repro.models.transformer``:

  dense   pre-norm attention + MLP blocks;
  hybrid  hymba: attention and a Mamba mixer run in parallel on the same
          normed input and are mixed with learned non-negative weights,
          then an MLP;
  moe     attention + a mixture-of-experts FFN (``models/moe.py``), whose
          load-balance loss each block returns as its aux.

Per-layer params are stacked on a leading L dim; a Python loop over that dim
replaces ``lax.scan``.  The other families (ssm, encdec, vlm) are not
ported yet and raise ``NotImplementedError``.

``forward_train`` trains with ``attention_impl="xla"``, as the reference's
``train_job`` does: no kernel has a backward (see ``kernels/ops.py``), so
the kernel routes (``"pallas"`` attention, and the hybrid block's scans)
raise under grad.  With ``remat=True`` each block runs under
``torch.utils.checkpoint`` and is recomputed whole in the backward.  The
reference's policy (``dots_with_no_batch_dims_saveable``) keeps the matmul
outputs and recomputes only the elementwise ops between them.  Both give
the same numbers; the port saves only each block's input, so it holds less
memory and does the block's matmuls once more.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.params import ParamDef, tree_map

Params = Dict[str, Any]

PORTED_FAMILIES = ("dense", "hybrid", "moe")


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
    d: Params = {"ln_attn": L.norm_defs(cfg), "attn": L.attention_defs(cfg)}
    if cfg.family == "hybrid":
        d["ssm"] = SSM.ssm_defs(cfg)
        d["mix_w"] = ParamDef((2,), (None,), init="ones", dtype=torch.float32)
    d["ln_mlp"] = L.norm_defs(cfg)
    if cfg.family == "moe":
        d["moe"] = MOE.moe_defs(cfg)
    else:
        d["mlp"] = L.mlp_defs(cfg)
    return d


def model_defs(cfg: ModelConfig) -> Params:
    """Full parameter tree; the blocks are stacked on a leading L dim (the
    dense, hybrid and moe archs all use ``layer_impl="scan"``)."""
    check_family(cfg)
    if cfg.layer_impl != "scan":
        raise NotImplementedError(f"layer_impl={cfg.layer_impl!r}: the port stacks layers")
    return {"embed": L.embed_defs(cfg), "ln_f": L.norm_defs(cfg),
            "blocks": stack_defs(block_defs(cfg), cfg.n_layers)}


def layer_params(blocks: Params, i: int) -> Params:
    """Layer i's params from the stacked blocks (the serving paths, which run
    without grad)."""
    return tree_map(lambda t: t[i], blocks)


def unbind_layers(blocks: Params) -> List[Params]:
    """Every layer's params from the stacked blocks, one ``torch.unbind`` per
    leaf.  Under grad, its backward stacks the L layer grads once; a ``t[i]``
    per layer would build a zero tensor the size of the whole leaf for each
    layer and sum L of them."""
    if isinstance(blocks, dict):
        per_key = {k: unbind_layers(v) for k, v in blocks.items()}
        n = len(next(iter(per_key.values())))
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(torch.unbind(blocks, 0))


def mix(p: Params, x: torch.Tensor, attn_out: torch.Tensor, ssm_out: torch.Tensor
        ) -> torch.Tensor:
    """x + relu(mix_w) . (attn_out, ssm_out), summed in f32 and cast back."""
    w = torch.relu(p["mix_w"])  # learned non-negative mixing
    return x + (w[0] * attn_out.float() + w[1] * ssm_out.float()).to(x.dtype)


def _ffn(p: Params, xn2: torch.Tensor, cfg: ModelConfig
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The block's feed-forward on its normed input: (out, aux).  The moe
    family's MoE layer returns its load-balance loss as ``aux``; the MLP of
    the other families returns None."""
    if cfg.family == "moe":
        return MOE.apply_moe(p["moe"], xn2, cfg)
    return L.apply_mlp(p["mlp"], xn2, cfg.activation), None


def _apply_block(p: Params, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor],
                            Dict[str, torch.Tensor], Optional[torch.Tensor]]:
    """One decoder block.  Returns (x, (k, v), state, aux): ``state`` is the
    hybrid block's recurrent state {conv, ssm}, empty for the others; ``aux``
    is the moe block's load-balance loss, None for the others (``_ffn``)."""
    xn = L.apply_norm(p["ln_attn"], x, cfg.norm)
    attn_out, (k, v) = L.attn_forward(p["attn"], xn, positions, cfg)
    state: Dict[str, torch.Tensor] = {}
    if cfg.family == "hybrid":
        ssm_out, state = SSM.ssm_forward(p["ssm"], xn, cfg)
        x = mix(p, x, attn_out, ssm_out)
    else:
        x = x + attn_out
    ffn_out, aux = _ffn(p, L.apply_norm(p["ln_mlp"], x, cfg.norm), cfg)
    return x + ffn_out, (k, v), state, aux


def _embed_inputs(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (x, positions, tokens)."""
    check_family(cfg)
    tokens = batch["tokens"]
    x = L.embed_tokens(params["embed"], tokens, cfg)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    return x, positions, tokens


# ---------------------------------------------------------------------------
# Training forward + loss
# ---------------------------------------------------------------------------


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor
                  ) -> torch.Tensor:
    """Mean next-token NLL over the mask, in f32: sum((lse - gold) * mask) /
    max(sum(mask), 1)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    nll = (lse - gold) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1.0)


def forward_train(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                  remat: bool = True) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total, {"loss", "aux"}) for a batch of {tokens, targets (B,S) int32,
    mask (B,S) f32}; total = loss + 0.01 * aux, where aux is the sum over
    the layers of the moe load-balance loss (an f32 zero for the dense and
    hybrid families)."""
    x, positions, _ = _embed_inputs(params, cfg, batch)

    def block(p: Params, h: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        out = _apply_block(p, h, positions, cfg)
        return out[0], out[3]

    auxs = []
    for lp in unbind_layers(params["blocks"]):
        x, aux = checkpoint(block, lp, x, use_reentrant=False) if remat else block(lp, x)
        if aux is not None:
            auxs.append(aux)
    x = L.apply_norm(params["ln_f"], x, cfg.norm)
    logits = L.unembed(params["embed"], x, cfg)
    loss = cross_entropy(logits, batch["targets"], batch["mask"])
    aux = (torch.stack(auxs).sum() if auxs
           else torch.zeros((), dtype=torch.float32, device=loss.device))
    return loss + 0.01 * aux, {"loss": loss, "aux": aux}
