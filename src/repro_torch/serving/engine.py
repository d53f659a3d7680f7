"""Batched serving engine with continuous batching (slot refill).

Port of ``repro.serving.engine`` for the dense, hybrid, moe and ssm (xlstm)
families (``UNSERVED_FAMILIES`` says why not the vlm and encdec ones; they
decode through ``models.decoding.prefill`` and ``decode_step``).  A fixed
pool of ``max_batch`` decode slots shares one batched cache.  A free slot is
filled by prefilling the request at batch 1 and copying its cache into the
slot, in place, on the batch axis: axis 1 of ``k``/``v``/``conv``/``ssm``,
axis 0 of ``pos`` and of every xlstm state leaf.  Decode ticks advance every
slot one token; finished slots are refilled at once.

Dense prompts are right-padded to ``prefill_len`` and masked through the
cache's valid length (``pos``): admission rewinds ``pos`` to
``len(prompt) - 1``, so the first decode re-processes the last prompt token
(a KV write) and yields the first new token.  The moe family follows the
dense rules, as in the reference: its first decode routes that token as a
group of one, with no drops, so where the prefill dropped it the K/V
rewritten at layers >= 1 differ from the prefill's.  Recurrent families
(hybrid, ssm) fold pads into their state and re-processing a token is not
idempotent, so their prompts must be exactly ``prefill_len`` long, the first
token comes from the prefill logits, ``pos`` is not rewound, and a request
that is done after that token never takes a slot.

The reference's engine inserts the xlstm mLSTM's ``conv`` state (B,3,dp) on
axis 1, because its ``_batch_axis`` matches the ``'conv'`` marker of the
hybrid cache; its own comment says xlstm states are batch-first, and with
more than one slot admitting into slot k > 0 overwrites slot 0's conv state
(ROADMAP.md, R3).  The port inserts every xlstm leaf on axis 0, as that
comment intends: at ``max_batch=1`` it gives the reference engine's tokens,
and at ``max_batch > 1`` each request's tokens are those it decodes alone.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import decoding as DEC
from repro_torch.models.transformer import check_family
from repro_torch.steps import resolve_device

Params = Dict[str, Any]
RECURRENT_FAMILIES = ("hybrid", "ssm")
# ported families the engine refuses, as the reference's does (engine.py:54
# there), and why; the reference's jitted prefill passes {"tokens"} alone,
# which its vlm embedding cannot take
UNSERVED_FAMILIES = {
    "encdec": "the serving engine targets decoder LMs",
    "vlm": "the serving engine feeds a prefill its tokens alone, and the vlm family "
           "also needs img_embeds",
}


@dataclasses.dataclass
class Request:
    id: int
    prompt: List[int]
    max_new_tokens: int
    eos_id: Optional[int] = None
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    next_input: int = 0


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params: Params, *, max_batch: int = 4,
                 max_len: int = 128, prefill_len: int = 32, device="cuda"):
        check_family(cfg)
        if cfg.family in UNSERVED_FAMILIES:
            raise NotImplementedError(
                f"{cfg.name} ({cfg.family}): {UNSERVED_FAMILIES[cfg.family]}; decode it "
                "through repro_torch.models.decoding.prefill and decode_step")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.max_len = max_len
        self.prefill_len = prefill_len
        self._ids = itertools.count()
        self.pending: deque = deque()
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.finished: Dict[int, Request] = {}
        self.stats = {"prefills": 0, "decode_ticks": 0, "tokens": 0}
        self.cache = DEC.init_cache(cfg, max_batch, max_len, device=self.device)

    # -- public ------------------------------------------------------------

    def submit(self, prompt: List[int], max_new_tokens: int = 16,
               eos_id: Optional[int] = None) -> int:
        if not prompt:
            raise ValueError("empty prompt")
        if self.cfg.family in RECURRENT_FAMILIES and len(prompt) != self.prefill_len:
            raise ValueError(
                f"recurrent family {self.cfg.family!r} needs exact-length "
                f"prompts ({self.prefill_len}); got {len(prompt)}")
        if len(prompt) > self.prefill_len:
            raise ValueError(f"prompt longer than prefill_len={self.prefill_len}")
        rid = next(self._ids)
        self.pending.append(Request(rid, list(prompt), max_new_tokens, eos_id))
        return rid

    def run_until_idle(self, max_ticks: int = 10_000) -> Dict[int, List[int]]:
        for _ in range(max_ticks):
            if not self.step():
                break
        return {rid: r.generated for rid, r in self.finished.items()}

    @torch.no_grad()
    def step(self) -> bool:
        """One engine tick: admit into free slots, then decode.  Returns
        False when fully idle."""
        admitted = False
        for i, slot in enumerate(self.slots):
            if slot is None and self.pending:
                self._admit(i, self.pending.popleft())
                admitted = True
        if not any(r is not None for r in self.slots):
            return admitted
        self._decode_tick()
        return True

    # -- internals ------------------------------------------------------------

    def _admit(self, slot: int, req: Request) -> None:
        plen = len(req.prompt)
        toks = torch.zeros((1, self.prefill_len), dtype=torch.long)
        toks[0, :plen] = torch.tensor(req.prompt, dtype=torch.long)
        logits1, cache1 = DEC.prefill(self.params, self.cfg, {"tokens": toks.to(self.device)},
                                      max_len=self.max_len)
        self.stats["prefills"] += 1
        if self.cfg.family in RECURRENT_FAMILIES:
            # recurrent state is not idempotent: the first token comes from
            # the prefill logits (the prompt is exact-length)
            first = int(logits1[0, -1].argmax())
            req.generated.append(first)
            req.next_input = first
            self.stats["tokens"] += 1
            if (len(req.generated) >= req.max_new_tokens
                    or (req.eos_id is not None and first == req.eos_id)):
                req.done = True
                self.finished[req.id] = req
                return
            self.cache["pos"][slot] = plen
        else:
            # rewind one token: the first decode re-processes the last prompt
            # token (idempotent kv write), yielding the first new-token logits
            self.cache["pos"][slot] = plen - 1
            req.next_input = req.prompt[-1]
        if self.cfg.family == "ssm":  # batch-first state leaves
            for dst, src in zip(self.cache["blocks"], cache1["blocks"]):
                for key, t in src.items():
                    dst[key][slot] = t[0]
        else:
            for key, t in cache1.items():  # every other leaf has batch axis 1
                if key != "pos":
                    self.cache[key][:, slot] = t[:, 0]
        self.slots[slot] = req

    def _decode_tick(self) -> None:
        toks = torch.tensor([[r.next_input if r is not None else 0] for r in self.slots],
                            dtype=torch.long)
        logits, self.cache = DEC.decode_step(self.params, self.cfg, self.cache,
                                             toks.to(self.device))
        # greedy: argmax takes the first maximum, as jnp.argmax does
        nxt = logits[:, -1, :].argmax(dim=-1).tolist()
        pos = self.cache["pos"].tolist()
        self.stats["decode_ticks"] += 1
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            tok = int(nxt[i])
            req.generated.append(tok)
            req.next_input = tok
            self.stats["tokens"] += 1
            if (len(req.generated) >= req.max_new_tokens
                    or (req.eos_id is not None and tok == req.eos_id)
                    or pos[i] >= self.max_len - 1):
                req.done = True
                self.finished[req.id] = req
                self.slots[i] = None
