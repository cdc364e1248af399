"""Synthetic-but-learnable LM data pipeline, the JAX package's
(``src/repro/training/data.py``) with its arithmetic unchanged: the same
seed gives the same tokens.

Generates token streams from a sampled bigram chain (fixed seed), so a
model trained on it shows a real, monotone loss decrease toward the chain's
conditional entropy — good enough to validate the training substrate end to
end without shipping a corpus.  Deterministic, shardable, restartable.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass
class BigramLM:
    vocab_size: int
    branching: int = 8          # successors per token
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.successors = rng.integers(
            0, self.vocab_size, size=(self.vocab_size, self.branching)
        )
        probs = rng.dirichlet(np.ones(self.branching) * 0.5, size=self.vocab_size)
        self.probs = probs

    def sample(self, rng: np.random.Generator, batch: int, length: int) -> np.ndarray:
        out = np.empty((batch, length + 1), np.int32)
        cur = rng.integers(0, self.vocab_size, size=batch)
        out[:, 0] = cur
        for t in range(length):
            choice = np.array(
                [rng.choice(self.branching, p=self.probs[c]) for c in cur]
            )
            cur = self.successors[cur, choice]
            out[:, t + 1] = cur
        return out


def data_iterator(vocab_size: int, batch: int, seq_len: int, *,
                  seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Yields {tokens [B,S], labels [B,S]} batches forever."""
    chain = BigramLM(vocab_size=vocab_size, seed=seed)
    rng = np.random.default_rng(seed + 1)
    while True:
        stream = chain.sample(rng, batch, seq_len)
        yield {"tokens": stream[:, :-1], "labels": stream[:, 1:]}
