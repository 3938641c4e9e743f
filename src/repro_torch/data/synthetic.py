"""Seeded synthetic batches: token streams for the LM serving and
training paths, class-conditioned images for the CNN accuracy harness,
and the smoke tests' host batch; the dry-run's batch specs.

The counterparts of ``repro.data.synthetic``'s ``SyntheticTokens``,
``SyntheticImages``, ``make_host_batch`` and ``make_batch_specs``: the
same numpy generators and the same draws, so both packages see
identical prompts and images from one seed. Only the result's type differs: torch tensors on the CPU
(the caller moves them to its device). ``make_host_batch``'s frames and
patch embeddings are the exception: see there.
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
        # ``Generator.choice(vocab, size, p=unigram)`` draws
        # ``cdf.searchsorted(random(size), side="right")`` with this cdf,
        # which it rebuilds from p on every call (O(vocab) a position);
        # built once here, the draws are the same
        cdf = self._unigram.cumsum()
        cdf /= cdf[-1]
        self._cdf = cdf
        self._rng = np.random.default_rng(seed + 1)

    def _unigram_draw(self, n: int) -> np.ndarray:
        return self._cdf.searchsorted(self._rng.random(n), side="right")

    def next_batch(self) -> dict:
        b, s = self.batch, self.seq
        out = np.empty((b, s), np.int32)
        cur = self._unigram_draw(b)
        out[:, 0] = cur
        for t in range(1, s):
            use_bigram = self._rng.random(b) < self._peak
            nxt = np.where(use_bigram, self._succ[cur],
                           self._unigram_draw(b))
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


def make_batch_specs(arch, shape) -> dict:
    """Stand-ins on the ``meta`` device for (arch, shape), the dry-run's
    inputs: ``tokens`` int32 [B, S] for a train or prefill shape (with an
    encoder-decoder's ``frames`` or a vision frontend's ``extra_embed``
    in bf16 [B, S, d_model]), else the decode step's ``token`` [B, 1];
    B, S the shape's global batch and sequence length."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        specs = {"tokens": torch.empty((b, s), dtype=torch.int32,
                                       device="meta")}
        name = {"encdec": "frames"}.get(arch.module)
        if name is None and arch.frontend == "vision":
            name = "extra_embed"
        if name is not None:
            specs[name] = torch.empty((b, s, arch.model.d_model),
                                      dtype=torch.bfloat16, device="meta")
        return specs
    # decode: one new token against a cache of length s
    return {"token": torch.empty((b, 1), dtype=torch.int32, device="meta")}


def make_host_batch(arch, batch: int, seq: int, seed: int = 0) -> dict:
    """Small concrete batch for smoke tests (reduced configs): ``tokens``
    from :class:`SyntheticTokens` at the smoke config's vocab (the
    reference's draws), plus, for an encoder-decoder, ``frames`` and, for
    a vision frontend, ``extra_embed``: 0.1 N(0, 1) of shape [batch, seq,
    d_model] in fp32, drawn from a CPU ``torch.Generator`` seeded with
    ``seed``. The reference draws them from ``jax.random.key(seed)``,
    whose numbers differ, so a test that compares the packages hands
    both the same numpy arrays."""
    vocab = arch.smoke.vocab if arch.smoke is not None else arch.model.vocab
    out = SyntheticTokens(vocab, batch, seq, seed).next_batch()
    d = (arch.smoke or arch.model).d_model
    name = {"encdec": "frames"}.get(arch.module)
    if name is None and arch.frontend == "vision":
        name = "extra_embed"
    if name is not None:
        gen = torch.Generator().manual_seed(seed)
        out[name] = 0.1 * torch.randn((batch, seq, d), generator=gen)
    return out
