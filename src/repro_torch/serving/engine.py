"""Batched serving engine with continuous batching (slot refill).

Port of ``repro.serving.engine`` for the dense family.  A fixed pool of
``max_batch`` decode slots shares one batched KV cache.  A free slot is
filled by prefilling the request at batch 1 and copying its cache into the
slot, in place, on the batch axis (axis 1 of ``k``/``v``, axis 0 of ``pos``).
Decode ticks advance every slot one token; finished slots are refilled at
once.

Prompts are right-padded to ``prefill_len`` and masked through the cache's
valid length (``pos``): admission rewinds ``pos`` to ``len(prompt) - 1``, so
the first decode re-processes the last prompt token (an idempotent KV write)
and yields the first new token.
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
        _, cache1 = DEC.prefill(self.params, self.cfg, {"tokens": toks.to(self.device)},
                                max_len=self.max_len)
        # rewind one token: the first decode re-processes the last prompt
        # token (idempotent kv write), yielding the first new-token logits
        self.cache["k"][:, slot] = cache1["k"][:, 0]
        self.cache["v"][:, slot] = cache1["v"][:, 0]
        self.cache["pos"][slot] = plen - 1
        req.next_input = req.prompt[-1]
        self.slots[slot] = req
        self.stats["prefills"] += 1

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
