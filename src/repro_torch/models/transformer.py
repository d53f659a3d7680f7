"""Model assembly for every family of the reference.

Port of ``repro.models.transformer``:

  dense   pre-norm attention + MLP blocks;
  vlm     the dense blocks over [img_proj(img_embeds); embed(tokens)]: the
          stub image frontend's patch embeddings, projected, then the text;
  hybrid  hymba: attention and a Mamba mixer run in parallel on the same
          normed input and are mixed with learned non-negative weights,
          then an MLP;
  moe     attention + a mixture-of-experts FFN (``models/moe.py``), whose
          load-balance loss each block returns as its aux;
  encdec  whisper: a bidirectional encoder over the stub frontend's frame
          embeddings plus a learned position table (``encode``), then a
          causal decoder over tokens plus a learned position table, each
          block with cross-attention to the encoder output.  As in the
          reference, only the decoder's causal self-attention reaches K1;
  ssm     xlstm: mLSTM blocks with an sLSTM block every
          ``cfg.xlstm.slstm_every``-th layer (``models/xlstm.py``), always
          a list of per-layer params.

With ``layer_impl="scan"`` per-layer params are stacked on a leading L dim
and a Python loop over that dim replaces ``lax.scan``; with ``"unroll"``
``blocks`` is a list of per-layer param dicts, as in the reference.

``forward_train`` trains with ``attention_impl="xla"``, as the reference's
``train_job`` does: no kernel has a backward (see ``kernels/ops.py``), so
``"pallas"`` attention raises under grad.  The hybrid block's Mamba mixer
trains through the reference's differentiable scans (``ssm_forward(...,
train=True)``), never through K3 or K4.  ``window`` > 0 limits its causal
self-attention to the last ``window`` keys, as in the reference (encdec
ignores it there and here).  With ``remat=True`` each decoder block runs
under ``torch.utils.checkpoint`` and is recomputed whole in the backward
(the encoder is not rematted, and neither are the xlstm blocks, as in the
reference).  The reference's policy (``dots_with_no_batch_dims_saveable``)
keeps the matmul outputs and recomputes only the elementwise ops between
them.  Both give the same numbers; the port saves only each block's input,
so it holds less memory and does the block's matmuls once more.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch import sharding as SH
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models import xlstm as XL
from repro_torch.models.params import ParamDef, tree_map
from repro_torch.parallel.ep import current_mesh, ep_mesh

Params = Dict[str, Any]

PORTED_FAMILIES = ("dense", "vlm", "hybrid", "moe", "encdec", "ssm")


def check_family(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported to repro_torch yet; "
            f"ported: {PORTED_FAMILIES}")


def stack_defs(defs: Any, n: int) -> Any:
    return tree_map(
        lambda d: ParamDef((n,) + d.shape, ("layers",) + d.axes, d.init, d.scale, d.dtype), defs)


def block_defs(cfg: ModelConfig) -> Params:
    """One decoder block of the dense, vlm, hybrid or moe family."""
    check_family(cfg)
    if cfg.family in ("encdec", "ssm"):
        raise ValueError(f"{cfg.family} has its own blocks: enc_block_defs and "
                         "dec_block_defs (encdec), xlstm_layer_kinds (ssm)")
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


def enc_block_defs(cfg: ModelConfig) -> Params:
    return {"ln_attn": L.norm_defs(cfg), "attn": L.attention_defs(cfg),
            "ln_mlp": L.norm_defs(cfg), "mlp": L.mlp_defs(cfg)}


def dec_block_defs(cfg: ModelConfig) -> Params:
    return {"ln_attn": L.norm_defs(cfg), "attn": L.attention_defs(cfg),
            "ln_cross": L.norm_defs(cfg), "cross": L.cross_attention_defs(cfg),
            "ln_mlp": L.norm_defs(cfg), "mlp": L.mlp_defs(cfg)}


def xlstm_layer_kinds(cfg: ModelConfig) -> List[str]:
    """"slstm" for every ``slstm_every``-th layer (1-based), else "mlstm"."""
    ev = cfg.xlstm.slstm_every
    return ["slstm" if (ev and (i + 1) % ev == 0) else "mlstm" for i in range(cfg.n_layers)]


def _layers(defs: Params, n: int, cfg: ModelConfig) -> Any:
    """n layers of ``defs``: stacked on a leading L dim, or a list of n."""
    return stack_defs(defs, n) if cfg.layer_impl == "scan" else [defs for _ in range(n)]


def model_defs(cfg: ModelConfig, max_seq: int = 0) -> Params:
    """Full parameter tree.  ``blocks`` is stacked on a leading L dim for
    ``layer_impl="scan"`` and a list of per-layer defs for ``"unroll"``
    (always for ssm).  ``max_seq`` sizes the decoder's absolute position
    table (encdec: ``max(max_seq, 8)`` rows, as in the reference); rope
    models ignore it."""
    check_family(cfg)
    if cfg.layer_impl not in ("scan", "unroll"):
        raise ValueError(f"layer_impl={cfg.layer_impl!r}")
    defs: Params = {"embed": L.embed_defs(cfg), "ln_f": L.norm_defs(cfg)}
    if cfg.family == "ssm":
        defs["blocks"] = [XL.mlstm_defs(cfg) if kind == "mlstm" else XL.slstm_defs(cfg)
                          for kind in xlstm_layer_kinds(cfg)]
    elif cfg.family == "encdec":
        defs["enc_blocks"] = _layers(enc_block_defs(cfg), cfg.n_enc_layers, cfg)
        defs["blocks"] = _layers(dec_block_defs(cfg), cfg.n_layers, cfg)
        defs["enc_ln_f"] = L.norm_defs(cfg)
        defs["enc_pos"] = L.posembed_defs(cfg, cfg.enc_frames)
        defs["dec_pos"] = L.posembed_defs(cfg, max(max_seq, 8))
    else:
        defs["blocks"] = _layers(block_defs(cfg), cfg.n_layers, cfg)
    if cfg.family == "vlm":
        defs["img_proj"] = {"w": ParamDef((cfg.d_model, cfg.d_model), ("embed", "embed_out"),
                                          dtype=L.adtype(cfg))}
    return defs


def layer_params(blocks: Any, i: int) -> Params:
    """Layer i's params from the stacked (or listed) blocks (the serving
    paths, which run without grad)."""
    if isinstance(blocks, list):
        return blocks[i]
    return tree_map(lambda t: t[i], blocks)


def unbind_layers(blocks: Any) -> List[Params]:
    """Every layer's params from the stacked blocks, one ``torch.unbind`` per
    leaf (listed blocks are returned as they are).  Under grad, its backward
    stacks the L layer grads once; a ``t[i]`` per layer would build a zero
    tensor the size of the whole leaf for each layer and sum L of them."""
    if isinstance(blocks, list):
        return blocks
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


def _apply_block(p: Params, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig,
                 enc: Optional[torch.Tensor] = None, window: int = 0, train: bool = False
                 ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor],
                            Dict[str, torch.Tensor], Optional[torch.Tensor]]:
    """One decoder block.  Returns (x, (k, v), state, aux): ``state`` holds
    the layer's other cache entries, the hybrid block's recurrent state
    {conv, ssm} or the encdec block's cross K/V {cross_k, cross_v} (projected
    from ``enc``, the encoder output), empty for the others; ``aux`` is the
    moe block's load-balance loss, None for the others (``_ffn``).
    ``window`` goes to the self-attention; ``train`` picks the hybrid
    mixer's differentiable scans over the scan kernels."""
    xn = L.apply_norm(p["ln_attn"], x, cfg.norm)
    attn_out, (k, v) = L.attn_forward(p["attn"], xn, positions, cfg, window=window)
    state: Dict[str, torch.Tensor] = {}
    if cfg.family == "hybrid":
        ssm_out, state = SSM.ssm_forward(p["ssm"], xn, cfg, train=train)
        x = mix(p, x, attn_out, ssm_out)
    else:
        x = x + attn_out
    if cfg.family == "encdec":
        xn = L.apply_norm(p["ln_cross"], x, cfg.norm)
        cross_out, (ck, cv) = L.attn_forward(p["cross"], xn, positions, cfg,
                                             kv_override=(enc, enc))
        x = x + cross_out
        state = {"cross_k": ck, "cross_v": cv}
    ffn_out, aux = _ffn(p, L.apply_norm(p["ln_mlp"], x, cfg.norm), cfg)
    return x + ffn_out, (k, v), state, aux


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def _embed_inputs(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (x, positions, tokens): the decoder's input stream.  vlm
    prepends the projected stub image embeddings (positions run over the
    whole sequence); encdec adds the decoder's position table."""
    check_family(cfg)
    tokens = batch["tokens"]
    x = L.embed_tokens(params["embed"], tokens, cfg)
    if cfg.family == "vlm":
        img = batch["img_embeds"].to(x.dtype) @ params["img_proj"]["w"]
        x = torch.cat([img, x], dim=1)
    if cfg.family == "encdec":
        x = x + params["dec_pos"]["pos"][None, :x.shape[1]]
    b, s, _ = x.shape
    return x, SH.replicate_like(_positions(b, s, x.device), x), tokens


def encode(params: Params, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """The encdec encoder: stub frame embeddings (B,F,d) plus its position
    table, bidirectional blocks (the plain attention path on every
    ``attention_impl``), then its final norm."""
    x = frames.to(L.adtype(cfg)) + params["enc_pos"]["pos"][None, :frames.shape[1]]
    positions = SH.replicate_like(_positions(x.shape[0], x.shape[1], x.device), x)
    for p in unbind_layers(params["enc_blocks"]):
        xn = L.apply_norm(p["ln_attn"], x, cfg.norm)
        x = x + L.attn_forward(p["attn"], xn, positions, cfg, causal=False)[0]
        x = x + L.apply_mlp(p["mlp"], L.apply_norm(p["ln_mlp"], x, cfg.norm), cfg.activation)
    return L.apply_norm(params["enc_ln_f"], x, cfg.norm)


def encoder_output(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]
                   ) -> Optional[torch.Tensor]:
    """``encode`` of the batch's ``enc_frames`` for encdec; None for the
    decoder-only families."""
    return encode(params, cfg, batch["enc_frames"]) if cfg.family == "encdec" else None


# ---------------------------------------------------------------------------
# Training forward + loss
# ---------------------------------------------------------------------------


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor
                  ) -> torch.Tensor:
    """Mean next-token NLL over the mask, in f32: sum((lse - gold) * mask) /
    max(sum(mask), 1)."""
    if isinstance(logits, DTensor):
        logits = SH.relayout(logits, [Replicate() if pl == Shard(logits.dim() - 1) else pl
                                      for pl in logits.placements])
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])
    if isinstance(gold, DTensor):
        # DTensor may gather from vocab shards (a masked partial sum); reduce
        # it here, while its mask still has the gather's shape: selecting
        # [..., 0] first leaves the mask behind (torch 2.13, a 16 x 16 mesh)
        gold = SH.relayout(gold, [Replicate() if pl.is_partial() else pl
                                  for pl in gold.placements])
    gold = gold[..., 0]
    nll = (lse - gold) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1.0)


def forward_train(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                  window: int = 0, remat: bool = True
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total, {"loss", "aux"}) for a batch of {tokens, targets (B,S) int32,
    mask (B,S) f32}, plus the stub frontend's ``img_embeds`` (vlm) or
    ``enc_frames`` (encdec); total = loss + 0.01 * aux, where aux is the sum
    over the layers of the moe load-balance loss (an f32 zero for the other
    families).  ``window`` > 0 is the sliding window of the self-attention
    (ignored by encdec and ssm, as in the reference)."""
    enc = encoder_output(params, cfg, batch)
    x, positions, tokens = _embed_inputs(params, cfg, batch)
    window = window if cfg.family != "encdec" else 0
    mesh = current_mesh()

    def block(p: Params, h: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        # remat recomputes a block in the backward, which on a card runs on
        # the autograd engine's device thread: the step's mesh, installed in
        # this thread (ep_mesh), is installed there again
        with ep_mesh(mesh):
            out = _apply_block(p, h, positions, cfg, enc, window=window, train=True)
        return out[0], out[3]

    auxs = []
    if cfg.family == "ssm":
        x, _ = _run_xlstm(params, x, cfg)
    else:
        for lp in unbind_layers(params["blocks"]):
            x, aux = checkpoint(block, lp, x, use_reentrant=False) if remat else block(lp, x)
            if aux is not None:
                auxs.append(aux)
    x = L.apply_norm(params["ln_f"], x, cfg.norm)
    if cfg.family == "vlm":  # strip the image positions before the unembedding
        x = x[:, -tokens.shape[1]:]
    logits = L.unembed(params["embed"], x, cfg)
    loss = cross_entropy(logits, batch["targets"], batch["mask"])
    aux = (torch.stack(auxs).sum() if auxs
           else torch.zeros((), dtype=torch.float32, device=loss.device))
    return loss + 0.01 * aux, {"loss": loss, "aux": aux}


def _run_xlstm(params: Params, x: torch.Tensor, cfg: ModelConfig
               ) -> Tuple[torch.Tensor, List[Dict[str, torch.Tensor]]]:
    """The xlstm stack over the whole sequence: (x, each layer's decode
    state).  The mLSTM's residual is added here, the sLSTM adds its own."""
    states = []
    for kind, p in zip(xlstm_layer_kinds(cfg), params["blocks"]):
        if kind == "mlstm":
            out, st = XL.mlstm_forward(p, x, cfg)
            x = x + out
        else:
            x, st = XL.slstm_forward(p, x, cfg)
        states.append(st)
    return x, states
