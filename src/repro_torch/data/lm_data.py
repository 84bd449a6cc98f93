"""Deterministic synthetic LM data (PyTorch port of ``repro.data.lm_data``).

An infinite, seekable stream of (tokens, labels) batches: batch i is a pure
function of (seed, i), so a resumed run sees exactly the batches it would
have seen.  The draws are the reference's numpy draws, so the tokens equal
the reference's; they come out as int64 CPU tensors (the caller moves them
to its device).

The token distribution is a Zipf-ish unigram mix with Markov bigram
structure, so cross-entropy has learnable signal.  ``batch_at`` samples one
position at a time on the host, which dominates a short training run;
ROADMAP item 43 queues a faster generator.
"""
from __future__ import annotations

import numpy as np
import torch


class SyntheticLM:
    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0):
        self.vocab = vocab_size
        self.seq = seq_len
        self.batch = global_batch
        self.seed = seed
        rng = np.random.default_rng(seed)
        # low-rank bigram logits give the stream learnable structure
        r = 16
        self._u = rng.standard_normal((vocab_size, r)).astype(np.float32)
        self._v = rng.standard_normal((r, vocab_size)).astype(np.float32)

    @staticmethod
    def _split(toks: np.ndarray) -> dict:
        return {"tokens": torch.from_numpy(np.ascontiguousarray(toks[:, :-1])),
                "labels": torch.from_numpy(np.ascontiguousarray(toks[:, 1:]))}

    def batch_at(self, step: int) -> dict:
        """Global batch for ``step`` — pure function of (seed, step)."""
        rng = np.random.default_rng((self.seed, step))
        B, S, V = self.batch, self.seq, self.vocab
        toks = np.empty((B, S + 1), np.int64)
        toks[:, 0] = rng.integers(0, V, B)
        # blockwise Markov sampling (vectorised over batch)
        for t in range(S):
            logits = self._u[toks[:, t]] @ self._v    # (B, V)
            gumbel = rng.gumbel(size=logits.shape).astype(np.float32)
            toks[:, t + 1] = np.argmax(logits / 2.0 + gumbel, axis=-1)
        return self._split(toks)

    def fast_batch_at(self, step: int) -> dict:
        """iid unigram batch (no Markov loop) — for throughput tests."""
        rng = np.random.default_rng((self.seed, step))
        B, S, V = self.batch, self.seq, self.vocab
        z = rng.zipf(1.3, size=(B, S + 1)).clip(1, V) - 1
        return self._split(z.astype(np.int64))
