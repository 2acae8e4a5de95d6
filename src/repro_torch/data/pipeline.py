"""Deterministic, shardable, checkpointable synthetic token stream (port of
``repro.data.pipeline``, a numpy copy: the port imports nothing of the
reference).

* **Determinism**: batch ``i`` is a pure function of (seed, i, shard), so a
  restart from a checkpointed cursor reproduces the stream exactly.
* **Sharding**: each data-parallel shard draws its own slice by
  ``(shard_index, num_shards)``; no coordination or file state.
* **Checkpointability**: the state is one cursor and the seed, stored in
  every training checkpoint.

Tokens are Zipf draws with an n-gram echo (token ``t`` repeats token
``t - ngram_order`` shifted by a per-seed constant with probability 1/2),
so a language-model loss can fall on it.  Batches are numpy arrays, bit
for bit the reference's; the training step moves them to its device.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

__all__ = ["DataConfig", "TokenPipeline"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    ngram_order: int = 3
    frontend_positions: int = 0  # >0: also emit stub frontend embeddings
    frontend_dim: int = 0


@dataclasses.dataclass
class TokenPipeline:
    """Stateful cursor over the deterministic stream."""

    cfg: DataConfig
    shard_index: int = 0
    num_shards: int = 1
    cursor: int = 0

    def __post_init__(self):
        if self.cfg.global_batch % self.num_shards:
            raise ValueError(
                f"global_batch {self.cfg.global_batch} not divisible by "
                f"{self.num_shards} shards"
            )
        # the per-seed echo shift, drawn identically on every shard
        rng = np.random.default_rng(self.cfg.seed)
        v = self.cfg.vocab_size
        self._base_probs = 1.0 / np.arange(1, v + 1) ** self.cfg.zipf_a
        self._base_probs /= self._base_probs.sum()
        self._shift = rng.integers(1, max(2, v - 1))

    @property
    def local_batch(self) -> int:
        return self.cfg.global_batch // self.num_shards

    def _batch_at(self, step: int) -> dict:
        """Pure function of (seed, step, shard) -> local batch."""
        c = self.cfg
        rng = np.random.default_rng(
            (c.seed * 1_000_003 + step) * 65_537 + self.shard_index
        )
        b = self.local_batch
        toks = rng.choice(c.vocab_size, size=(b, c.seq_len), p=self._base_probs)
        echo = (np.roll(toks, c.ngram_order, axis=1) + self._shift) % c.vocab_size
        mask = rng.random((b, c.seq_len)) < 0.5
        toks = np.where(mask, echo, toks)
        toks[:, : c.ngram_order] = toks[:, : c.ngram_order] % c.vocab_size
        batch = {"tokens": toks.astype(np.int32)}
        if c.frontend_positions:
            batch["frontend"] = rng.standard_normal(
                (b, c.frontend_positions, c.frontend_dim), dtype=np.float32
            )
        return batch

    def next(self) -> dict:
        batch = self._batch_at(self.cursor)
        self.cursor += 1
        return batch

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next()

    # ---- checkpoint integration ----
    def state(self) -> dict:
        return {"cursor": self.cursor, "seed": self.cfg.seed}

    def restore(self, state: dict) -> None:
        if state.get("seed", self.cfg.seed) != self.cfg.seed:
            raise ValueError("pipeline seed mismatch on restore")
        self.cursor = int(state["cursor"])

    def reshard(self, shard_index: int, num_shards: int) -> "TokenPipeline":
        """Elastic rescale: the same stream, a new shard geometry (cursor kept)."""
        return TokenPipeline(
            cfg=self.cfg,
            shard_index=shard_index,
            num_shards=num_shards,
            cursor=self.cursor,
        )
