"""Synthetic LM token pipeline with checkpointable cursor state (a copy of
``repro.data.tokens``, numpy only, so its batches are the reference's bit
for bit).

Deterministic, seekable stream: batch ``i`` is a pure function of
``(seed, i)``, so restoring ``cursor`` from a checkpoint resumes the exact
stream — the data-pipeline half of fault tolerance.
The distribution is a Zipf-ish unigram mix with Markov bigram structure so
the loss curve is non-trivial (a pure-uniform stream has nothing to learn).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TokenPipeline:
    vocab: int
    batch: int
    seq_len: int
    seed: int = 0
    cursor: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        ranks = np.arange(1, self.vocab + 1, dtype=np.float64)
        self._unigram = (1.0 / ranks) / np.sum(1.0 / ranks)
        # sparse "grammar": each token prefers a handful of successors
        self._succ = rng.integers(0, self.vocab, size=(self.vocab, 4))

    def next_batch(self) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, self.cursor))
        toks = np.empty((self.batch, self.seq_len + 1), np.int32)
        toks[:, 0] = rng.choice(self.vocab, size=self.batch, p=self._unigram)
        follow = rng.random(size=(self.batch, self.seq_len)) < 0.7
        succ_pick = rng.integers(0, 4, size=(self.batch, self.seq_len))
        fresh = rng.choice(
            self.vocab, size=(self.batch, self.seq_len), p=self._unigram
        )
        for t in range(self.seq_len):
            nxt = self._succ[toks[:, t], succ_pick[:, t]]
            toks[:, t + 1] = np.where(follow[:, t], nxt, fresh[:, t])
        self.cursor += 1
        return {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:].astype(np.int32),
        }

    def state(self) -> dict:
        return {"seed": self.seed, "cursor": self.cursor}

    def restore(self, state: dict) -> None:
        assert state["seed"] == self.seed, "pipeline seed mismatch"
        self.cursor = int(state["cursor"])
