"""Seeded synthetic token batches for the LM serving path.

The counterpart of ``repro.data.synthetic.SyntheticTokens``: the same
numpy generator and the same draws, so both packages serve identical
prompts from one seed. Only the result's type differs: a ``torch.int32``
tensor on the CPU (the caller moves it to its device).
"""
from __future__ import annotations

import numpy as np
import torch


class SyntheticTokens:
    """Deterministic LM batch stream: p(next | cur) is a fixed sparse
    bigram table over a Zipf unigram prior."""

    def __init__(self, vocab: int, batch: int, seq: int, seed: int = 0,
                 bigram_peak: float = 0.8):
        self.vocab, self.batch, self.seq = vocab, batch, seq
        rng = np.random.default_rng(seed)
        self._succ = rng.integers(0, vocab, size=vocab)   # bigram successor
        self._peak = bigram_peak
        ranks = np.arange(1, vocab + 1, dtype=np.float64)
        p = 1.0 / ranks
        self._unigram = p / p.sum()
        self._rng = np.random.default_rng(seed + 1)

    def next_batch(self) -> dict:
        b, s = self.batch, self.seq
        out = np.empty((b, s), np.int32)
        cur = self._rng.choice(self.vocab, size=b, p=self._unigram)
        out[:, 0] = cur
        for t in range(1, s):
            use_bigram = self._rng.random(b) < self._peak
            nxt = np.where(use_bigram, self._succ[cur],
                           self._rng.choice(self.vocab, size=b,
                                            p=self._unigram))
            out[:, t] = nxt
            cur = nxt
        return {"tokens": torch.from_numpy(out)}

    def __iter__(self):
        while True:
            yield self.next_batch()
