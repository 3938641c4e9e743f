"""Seeded synthetic batches: token streams for the LM serving path,
class-conditioned images for the CNN accuracy harness.

The counterparts of ``repro.data.synthetic``'s ``SyntheticTokens`` and
``SyntheticImages``: the same numpy generators and the same draws, so
both packages see identical prompts and images from one seed. Only the
result's type differs: torch tensors on the CPU (the caller moves them
to its device).
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


class SyntheticImages:
    """Class-conditioned Gaussian images for the CNN accuracy harness."""

    def __init__(self, n_classes: int, batch: int, hw: int, seed: int = 0,
                 snr: float = 3.0, sample_seed: int | None = None):
        """``seed`` fixes the class prototypes (the task); ``sample_seed``
        varies the noise/draws — train and test streams share ``seed``
        but use different ``sample_seed`` values."""
        self.n_classes, self.batch, self.hw = n_classes, batch, hw
        rng = np.random.default_rng(seed)
        self._proto = rng.standard_normal(
            (n_classes, hw, hw, 3)).astype(np.float32)
        self._snr = snr
        self._rng = np.random.default_rng(
            seed + 1 if sample_seed is None else sample_seed)

    def next_batch(self) -> dict:
        """``images`` float32 [batch, hw, hw, 3] (NHWC) and ``labels``
        int32 [batch]."""
        labels = self._rng.integers(0, self.n_classes, self.batch)
        noise = self._rng.standard_normal(
            (self.batch, self.hw, self.hw, 3)).astype(np.float32)
        x = self._snr * self._proto[labels] + noise
        return {"images": torch.from_numpy(x),
                "labels": torch.from_numpy(labels.astype(np.int32))}

    def __iter__(self):
        while True:
            yield self.next_batch()
