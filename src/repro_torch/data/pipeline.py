"""Deterministic, sharding-aware synthetic LM data pipeline
(``repro/data/pipeline.py``, line for line: numpy's counter-based Philox,
so every batch is bit-identical to the reference's). It yields numpy
arrays; the trainer moves each batch to its device.

Production posture without an external corpus: token streams are generated
from a counter-based PRNG (stateless — any (host, step) pair regenerates
its shard deterministically, which is what makes checkpoint-restart and
elastic resharding exact), packed into fixed-length sequences, and
prefetched on a background thread.

Key properties the tests pin down:
  * determinism: stream(step) identical across restarts,
  * disjointness: different data-parallel shards never overlap,
  * elasticity: re-sharding to a different dp_size re-partitions the same
    global stream (global batch content is invariant),
  * failure injection: `fail_at` raises at a chosen step (FT tests).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # structured synthetic task: next-token = (token * a + b) % vocab on a
    # noisy copy channel — learnable, so training losses move (tests).
    task: str = "affine"   # affine | uniform
    noise: float = 0.05


def _batch_for_step(cfg: DataConfig, step: int) -> np.ndarray:
    """Global batch of tokens (global_batch, seq_len+1), deterministic."""
    rng = np.random.Generator(np.random.Philox(key=cfg.seed, counter=[0, 0, 0, step]))
    B, S = cfg.global_batch, cfg.seq_len + 1
    if cfg.task == "uniform":
        return rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int64)
    # affine-chain task
    a = 31 % cfg.vocab_size or 1
    b = 17 % cfg.vocab_size
    x0 = rng.integers(0, cfg.vocab_size, (B,))
    toks = np.empty((B, S), np.int64)
    toks[:, 0] = x0
    for t in range(1, S):
        toks[:, t] = (toks[:, t - 1] * a + b) % cfg.vocab_size
    flip = rng.random((B, S)) < cfg.noise
    toks[flip] = rng.integers(0, cfg.vocab_size, flip.sum())
    return toks


class DataPipeline:
    """Iterator over host-local shards of the global stream."""

    def __init__(
        self,
        cfg: DataConfig,
        *,
        dp_rank: int = 0,
        dp_size: int = 1,
        start_step: int = 0,
        prefetch: int = 2,
        fail_at: Optional[int] = None,
    ):
        assert cfg.global_batch % dp_size == 0, (cfg.global_batch, dp_size)
        self.cfg = cfg
        self.dp_rank = dp_rank
        self.dp_size = dp_size
        self.step = start_step
        self.fail_at = fail_at
        self._q: "queue.Queue" = queue.Queue(maxsize=max(prefetch, 1))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _make(self, step: int) -> Dict[str, np.ndarray]:
        if self.fail_at is not None and step == self.fail_at:
            raise RuntimeError(f"injected data failure at step {step}")
        g = _batch_for_step(self.cfg, step)
        per = self.cfg.global_batch // self.dp_size
        shard = g[self.dp_rank * per:(self.dp_rank + 1) * per]
        return {
            "tokens": shard[:, :-1].astype(np.int32),
            "labels": shard[:, 1:].astype(np.int32),
        }

    def _producer(self):
        step = self.step
        while not self._stop.is_set():
            try:
                item = self._make(step)
            except Exception as e:  # surface injected failures to consumer
                self._q.put(e)
                return
            self._q.put(item)
            step += 1

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        self.step += 1
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    # ---- stateless access (tests / restart logic) ----
    def peek_step(self, step: int) -> Dict[str, np.ndarray]:
        return self._make(step)


def global_batch_at(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    g = _batch_for_step(cfg, step)
    return {"tokens": g[:, :-1].astype(np.int32),
            "labels": g[:, 1:].astype(np.int32)}
