"""Deterministic synthetic token pipeline, sharded by host.

The port's own copy of ``repro.data.pipeline``, numpy only: batches are
numpy arrays, and the caller moves them to its device.

Determinism contract: batch contents are a pure function of
(seed, step, shard, n_shards), bit for bit the JAX package's.  A restarted
job therefore re-reads EXACTLY the sequence of batches it would have seen,
which is what makes checkpoint resume testable (loss curves continue
identically after a kill).

Task ``affine``: t[i+1] = (a * t[i] + c) mod vocab with fixed co-prime
``a``: a bijection a model learns quickly, so training runs show real loss
decrease.  Task ``uniform``: i.i.d. tokens (for throughput benches).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    task: str = "affine"   # affine | uniform
    seed: int = 0

    def __post_init__(self):
        if self.global_batch <= 0 or self.seq_len <= 0:
            raise ValueError("batch/seq must be positive")


def _affine_coeffs(vocab: int, seed: int):
    # pick a multiplier co-prime with vocab (odd works for even vocab; search)
    rng = np.random.RandomState(seed ^ 0x5EED)
    while True:
        a = int(rng.randint(1, max(vocab, 2)))
        if np.gcd(a, vocab) == 1:
            return a, int(rng.randint(0, vocab))


class SyntheticDataset:
    """Stateless batch source: ``batch(step, shard, n_shards)``."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._a, self._c = _affine_coeffs(cfg.vocab, cfg.seed)

    def batch(self, step: int, shard: int = 0, n_shards: int = 1) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        if cfg.global_batch % n_shards != 0:
            raise ValueError(f"global_batch {cfg.global_batch} % {n_shards} != 0")
        b = cfg.global_batch // n_shards
        # Stateless per-(step, shard) stream: independent of how many other
        # shards exist or ran before, so elastic-rescale safe as long as
        # (step, global position) pairs are preserved.
        rng = np.random.RandomState(
            (cfg.seed * 1_000_003 + step * 9_973 + shard * 7 + 1) % (2**31 - 1))
        if cfg.task == "uniform":
            toks = rng.randint(0, cfg.vocab, size=(b, cfg.seq_len + 1)).astype(np.int32)
        elif cfg.task == "affine":
            start = rng.randint(0, cfg.vocab, size=(b, 1)).astype(np.int64)
            seqs = [start]
            for _ in range(cfg.seq_len):
                seqs.append((self._a * seqs[-1] + self._c) % cfg.vocab)
            toks = np.concatenate(seqs, axis=1).astype(np.int32)
        else:
            raise ValueError(cfg.task)
        return {
            "tokens": toks[:, :-1],
            "targets": toks[:, 1:],
            "mask": np.ones((b, cfg.seq_len), np.float32),
        }

    def batches(self, start_step: int = 0, shard: int = 0, n_shards: int = 1
                ) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch(step, shard, n_shards)
            step += 1


def dataset_for(cfg: ModelConfig, shape: ShapeConfig, task: str = "affine",
                seed: int = 0) -> SyntheticDataset:
    return SyntheticDataset(DataConfig(vocab=cfg.vocab, seq_len=shape.seq_len,
                                       global_batch=shape.global_batch,
                                       task=task, seed=seed))


def with_frontend_stubs(batch: Dict[str, np.ndarray], cfg: ModelConfig,
                        seed: int = 0) -> Dict[str, np.ndarray]:
    """Attach the vlm / audio stub embeddings (precomputed patch / frame
    embeddings, N(0, 0.02^2), the same for every batch of a seed); the other
    families' batches pass through unchanged."""
    rng = np.random.RandomState(seed + 17)
    b = batch["tokens"].shape[0]
    if cfg.family == "vlm" and cfg.n_img_tokens:
        batch = dict(batch, img_embeds=rng.randn(
            b, cfg.n_img_tokens, cfg.d_model).astype(np.float32) * 0.02)
    if cfg.family == "encdec":
        batch = dict(batch, enc_frames=rng.randn(
            b, cfg.enc_frames, cfg.d_model).astype(np.float32) * 0.02)
    return batch
