"""Deterministic, shardable synthetic LM data pipeline.

A copy of ``repro.data.pipeline`` (pure numpy; ``tests/test_torch_train.py``
holds its batches byte-equal to the reference's).  Batches are numpy
arrays; the training loop moves them onto its device.

Design goals (DESIGN.md §5 fault tolerance):

  * **Deterministic by (seed, step, shard)** — every batch is a pure function
    of those three integers, so restarts resume bit-exactly and stragglers /
    re-scheduled shards regenerate identical data with no coordination.
  * **Shardable** — ``shard_batch(step, shard, num_shards)`` yields that
    shard's slice of the global batch; elastic rescale (num_shards changes)
    re-partitions the same global stream.
  * **Checkpointable** — pipeline state is just the step counter.

The token stream is a noisy affine recurrence (t_{i+1} ~ a*t_i + c + noise),
so models can actually learn it — example training runs show decreasing
loss rather than flat noise.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.1  # fraction of positions replaced by uniform noise
    mult: int = 5
    offset: int = 17


class SyntheticLMDataset:
    """Iterator-style access: ``global_batch(step)`` / ``shard_batch(...)``."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def _rng(self, step: int, row: int) -> np.random.Generator:
        # independent stream per (seed, step, row): stable under resharding
        return np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, step, row])
        )

    def _row(self, step: int, row: int) -> np.ndarray:
        cfg = self.cfg
        rng = self._rng(step, row)
        n = cfg.seq_len + 1
        toks = np.empty(n, np.int64)
        toks[0] = rng.integers(0, cfg.vocab)
        noise_mask = rng.random(n) < cfg.noise
        noise_vals = rng.integers(0, cfg.vocab, n)
        for i in range(1, n):
            toks[i] = (toks[i - 1] * cfg.mult + cfg.offset) % cfg.vocab
            if noise_mask[i]:
                toks[i] = noise_vals[i]
        return toks

    def global_batch(self, step: int) -> dict[str, np.ndarray]:
        rows = np.stack([self._row(step, r) for r in range(self.cfg.global_batch)])
        return {
            "tokens": rows[:, :-1].astype(np.int32),
            "labels": rows[:, 1:].astype(np.int32),
        }

    def shard_batch(self, step: int, shard: int, num_shards: int) -> dict[str, np.ndarray]:
        """This shard's contiguous slice of the global batch."""
        gb = self.cfg.global_batch
        if gb % num_shards:
            raise ValueError(f"global_batch {gb} not divisible by {num_shards} shards")
        per = gb // num_shards
        rows = np.stack(
            [self._row(step, r) for r in range(shard * per, (shard + 1) * per)]
        )
        return {
            "tokens": rows[:, :-1].astype(np.int32),
            "labels": rows[:, 1:].astype(np.int32),
        }

    # --- pipeline state (for checkpointing) ---
    @staticmethod
    def state(step: int) -> dict[str, int]:
        return {"step": int(step)}

    @staticmethod
    def restore(state: dict[str, int]) -> int:
        return int(state["step"])
