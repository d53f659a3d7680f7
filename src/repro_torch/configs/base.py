"""Config system: architecture + shape definitions.

Every assigned architecture is a ``ModelConfig`` produced by a module in
``repro_torch.configs``.  The modules are pure data, kept identical to the
JAX package's so that both accept the same ``--arch`` names.  Shapes (the benchmark cells) are ``ShapeConfig``s; the
cross-product, with documented skips, forms the dry-run / roofline matrix.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    # "dense" computes every expert for every token (tiny smoke configs only);
    # "dropping" is the GShard-style capacity-based dispatch (EP-shardable).
    routing_impl: str = "dropping"
    # pad expert WEIGHTS to this count (0 = no padding) so the expert axis
    # divides the mesh; padded experts are never routed to (§Perf: granite's
    # 40 experts pad to 48 for 16-way EP).
    n_experts_padded: int = 0

    @property
    def e_pad(self) -> int:
        return max(self.n_experts, self.n_experts_padded)


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    # "assoc": one associative scan over S — materializes (B,S,di,N); the
    # naive baseline.  "chunked": stream (B,chunk,di,N) tiles with a carried
    # state (the XLA mirror of kernels/ssm_scan.py) — §Perf optimization.
    scan_impl: str = "assoc"
    chunk: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model


@dataclass(frozen=True)
class XLSTMConfig:
    # every `slstm_every`-th block is an sLSTM block (xLSTM[m:s] ratio);
    # 0 disables sLSTM entirely.
    slstm_every: int = 4
    proj_factor: float = 2.0  # mLSTM up-projection factor


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    activation: str = "swiglu"  # swiglu | geglu | relu2 | gelu
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    embed_scale: bool = False  # gemma-style sqrt(d_model) embedding scaling
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    # hybrid (hymba): every block runs attention and mamba mixers in parallel
    hybrid_parallel: bool = False
    # encoder config (whisper): decoder uses the fields above
    n_enc_layers: int = 0
    enc_frames: int = 1500  # stub audio frontend: frames fed to the encoder
    # vlm stub frontend: number of image-embedding tokens prepended
    n_img_tokens: int = 0
    # sliding window (tokens) used in `long` shapes by hybrid archs; 0 = full
    long_window: int = 0
    # layer iteration: "scan" (homogeneous stacks) or "unroll"
    layer_impl: str = "scan"
    # attention implementation: xla | blockwise | pallas | pallas_interpret
    # (blockwise = q-chunked XLA flash — the dry-run-able stand-in for the
    #  Pallas kernel; bounds the S^2 working set)
    attention_impl: str = "xla"
    # q-chunk size for attention_impl="blockwise"
    attention_block_q: int = 512
    # "auto": XLA decides activations; "seq": constrain attention q/scores
    # to be sequence-sharded over "model" (the §Perf fix for MQA archs whose
    # few heads cannot use a 16-way TP axis)
    attention_partitioning: str = "auto"
    # shard the decode KV cache on the SEQUENCE dim over "model"
    # (flash-decode style; the §Perf fix for GQA kv_heads < mesh model axis)
    decode_seq_shard: bool = False
    dtype: str = "bfloat16"
    # notes recorded in DESIGN/EXPERIMENTS
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_subquadratic(self) -> bool:
        """Archs eligible for the long_500k shape (SSM / hybrid / linear-attn)."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs are decoders or enc-dec

    def n_params(self) -> int:
        """Analytic parameter count (used for 6ND model-FLOPs)."""
        d, h = self.d_model, self.resolved_head_dim
        nq, nkv = self.n_heads, self.n_kv_heads
        attn = d * (nq * h) + 2 * d * (nkv * h) + (nq * h) * d

        def mlp_params(dff: int) -> int:
            if self.activation in ("swiglu", "geglu"):
                return 3 * self.d_model * dff
            return 2 * self.d_model * dff

        per_layer = attn
        if self.family == "moe":
            assert self.moe is not None
            per_layer += self.moe.n_experts * mlp_params(self.moe.d_ff_expert)
            per_layer += self.moe.n_shared_experts * mlp_params(self.moe.d_ff_expert)
            per_layer += d * self.moe.n_experts  # router
        elif self.family == "ssm":
            per_layer = 0  # xlstm: no standard attention
            assert self.xlstm is not None
            dp = int(self.xlstm.proj_factor * d)
            per_layer += 2 * d * dp + dp * d + 3 * dp * h  # mlstm proj + qkv-ish
        else:
            per_layer += mlp_params(self.d_ff) if self.d_ff else 0
        if self.hybrid_parallel and self.ssm is not None:
            di = self.ssm.d_inner(d)
            per_layer += 2 * d * di + di * d + di * (self.ssm.d_conv + 2 * self.ssm.d_state + 2)
        total = self.n_layers * per_layer
        total += self.vocab * d * (1 if self.tie_embeddings else 2)
        if self.n_enc_layers:
            enc_attn = 4 * d * d
            total += self.n_enc_layers * (enc_attn + mlp_params(self.d_ff))
            total += self.n_layers * 4 * d * d  # decoder cross-attention
        return total

    def n_active_params(self) -> int:
        """Active params per token (MoE: only routed experts)."""
        if self.family != "moe":
            return self.n_params()
        assert self.moe is not None
        full = self.n_params()

        def mlp_params(dff: int) -> int:
            if self.activation in ("swiglu", "geglu"):
                return 3 * self.d_model * dff
            return 2 * self.d_model * dff

        all_exp = self.n_layers * self.moe.n_experts * mlp_params(self.moe.d_ff_expert)
        act_exp = self.n_layers * (self.moe.top_k + self.moe.n_shared_experts) * mlp_params(
            self.moe.d_ff_expert
        )
        return full - all_exp + act_exp


# ---------------------------------------------------------------------------
# Shapes (benchmark cells)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

ARCH_IDS: List[str] = [
    "phi-3-vision-4.2b",
    "hymba-1.5b",
    "moonshot-v1-16b-a3b",
    "granite-moe-3b-a800m",
    "phi3-mini-3.8b",
    "nemotron-4-340b",
    "granite-3-8b",
    "gemma-2b",
    "whisper-large-v3",
    "xlstm-125m",
]

_MODULE_FOR_ARCH = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(arch: str, **overrides: Any) -> ModelConfig:
    if arch not in _MODULE_FOR_ARCH:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(_MODULE_FOR_ARCH[arch])
    cfg: ModelConfig = mod.CONFIG
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def get_smoke_config(arch: str, **overrides: Any) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    mod = importlib.import_module(_MODULE_FOR_ARCH[arch])
    cfg: ModelConfig = mod.SMOKE
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def cells(include_skipped: bool = False) -> List[Tuple[str, str, str]]:
    """All (arch, shape, status) dry-run cells.

    status: "run" or "skip:<reason>".  long_500k is skipped for pure
    full-attention archs (see DESIGN.md §Arch-applicability).
    """
    out = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            status = "run"
            if shape.name == "long_500k" and not cfg.is_subquadratic:
                status = "skip:full-attention arch, 524k dense KV is quadratic-regime"
            if status == "run" or include_skipped:
                out.append((arch, shape.name, status))
    return out
