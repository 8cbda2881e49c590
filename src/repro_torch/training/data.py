"""Deterministic, checkpointable synthetic LM data pipeline.

Tokens follow a seeded Markov chain over the vocabulary, so a model can
actually LEARN the stream (loss drops well below log V) — used by the
training example and convergence tests. The iterator state is just
(seed, step) and is stored inside checkpoints; restart/elastic-resume
reproduces the exact stream, and each data shard reads a disjoint
deterministic slice (shard-aware skipping, no coordination needed).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class DataState:
    seed: int
    step: int = 0


class MarkovDataset:
    def __init__(self, vocab_size: int, *, seed: int = 0, branching: int = 4):
        self.vocab_size = vocab_size
        self.seed = seed
        rng = np.random.default_rng(seed)
        # sparse transition structure: each token -> `branching` successors
        self.next_tokens = rng.integers(
            0, vocab_size, size=(vocab_size, branching)
        ).astype(np.int32)
        self.probs = rng.dirichlet(np.ones(branching) * 0.5,
                                   size=vocab_size).astype(np.float32)
        self.entropy = float(
            -(self.probs * np.log(self.probs + 1e-9)).sum(-1).mean()
        )

    def batch(self, state: DataState, *, batch_size: int, seq_len: int,
              shard_id: int = 0, num_shards: int = 1):
        """Returns ({'inputs', 'labels'}, new_state). Deterministic in
        (seed, step, shard); shards draw disjoint streams."""
        rng = np.random.default_rng(
            (self.seed, state.step, shard_id, num_shards)
        )
        toks = np.empty((batch_size, seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab_size, size=batch_size)
        for t in range(seq_len):
            cur = toks[:, t]
            choice = (
                rng.random(batch_size)[:, None] >
                np.cumsum(self.probs[cur], -1)
            ).sum(-1)
            choice = np.minimum(choice, self.probs.shape[1] - 1)
            toks[:, t + 1] = self.next_tokens[cur, choice]
        batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
        return batch, DataState(state.seed, state.step + 1)
