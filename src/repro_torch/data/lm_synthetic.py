"""Deterministic synthetic LM corpus with restart-safe batching.

Counterpart of ``repro/data/lm_synthetic.py``: the same numpy draws in
the same order (the Dirichlet transitions and the emissions at ``seed``,
then ``default_rng((seed, step))`` for each batch), so a batch's tokens
are bitwise the JAX package's.  Batches are a pure function of
(seed, step): a run resumed from a checkpointed step sees exactly the
token stream it would have seen.  The corpus is a learnable order-2 Markov
chain over the vocabulary, so the loss falls within a few hundred steps.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["TokenStream"]


@dataclasses.dataclass
class TokenStream:
    vocab: int
    seq: int
    global_batch: int
    seed: int = 0
    markov_states: int = 64

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        s = self.markov_states
        self._trans = rng.dirichlet(np.full(s, 0.25), size=s).astype(np.float32)
        self._cum = np.cumsum(self._trans, axis=1)
        self._emit = rng.integers(0, self.vocab, size=s).astype(np.int64)

    def batch(self, step: int, extras: dict | None = None, device=None) -> dict:
        """{"tokens": (global_batch, seq) int32 on ``device`` (default the
        card)}, deterministic in (seed, step), with ``extras`` merged in."""
        rng = np.random.default_rng((self.seed, step))
        B, S, s = self.global_batch, self.seq, self.markov_states
        u = rng.random((B, S), dtype=np.float32)
        state = rng.integers(0, s, size=B)
        toks = np.empty((B, S), np.int64)
        for t in range(S):
            toks[:, t] = self._emit[state]
            state = (self._cum[state] < u[:, t : t + 1]).sum(axis=1).clip(0, s - 1)
        out = {"tokens": torch.from_numpy(toks.astype(np.int32)).to(resolve_device(device))}
        if extras:
            out.update(extras)
        return out
