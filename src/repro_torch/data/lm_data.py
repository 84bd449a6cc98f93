"""Deterministic synthetic LM data (PyTorch port of ``repro.data.lm_data``).

An infinite, seekable stream of (tokens, labels) batches: batch i is a pure
function of (seed, i), so a resumed run sees exactly the batches it would
have seen.  The draws are the reference's numpy draws, so the tokens equal
the reference's; they come out as int64 CPU tensors (the caller moves them
to its device).

The token distribution is a Zipf-ish unigram mix with Markov bigram
structure, so cross-entropy has learnable signal.  ``batch_at`` samples one
position at a time on the host.  At a full-width vocabulary its Gumbel
draws cost most of that, so they run ahead of the positions on a pool of
threads: each thread's copy of the generator is advanced to its position's
offset in the stream (``PCG64.advance``), which gives the sequential draws
bit for bit (``_gumbel_rows``).
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

PARALLEL_MIN = 1 << 15      # Gumbel draws a position from which threads pay
BLOCK_BYTES = 256 << 20     # float32 Gumbel rows drawn ahead at most


def _draw_row(base: dict, i: int, shape) -> tuple:
    """Position ``i``'s Gumbel draws (float32) from the stream that starts
    at generator state ``base``, and whether they took exactly one uniform
    each (numpy redraws a uniform of exactly 0, which shifts the stream)."""
    n = int(np.prod(shape))
    at = lambda j: _advanced(base, j * n)
    bg = at(i)
    g = np.random.Generator(bg).gumbel(size=shape).astype(np.float32)
    return g, bg.state["state"] == at(i + 1).state["state"]


def _advanced(base: dict, n: int):
    bg = np.random.PCG64()
    bg.state = base
    bg.advance(n)
    return bg


def _gumbel_rows(rng, n_pos: int, shape):
    """Yields ``rng.gumbel(size=shape).astype(float32)`` ``n_pos`` times in
    stream order.  From ``PARALLEL_MIN`` draws a position, threads draw
    blocks of up to ``BLOCK_BYTES`` of positions, each block before its
    positions are used (the Markov loop slows threefold beside busy
    threads, and small blocks wait on their slowest thread); where a
    position's draws shifted the stream, the rest are drawn in order from
    its start."""
    n = int(np.prod(shape))
    workers = min(8, len(os.sched_getaffinity(0)))
    if n < PARALLEL_MIN or workers < 2:
        for _ in range(n_pos):
            yield rng.gumbel(size=shape).astype(np.float32)
        return
    base = rng.bit_generator.state
    per = max(workers, BLOCK_BYTES // (4 * n))
    with ThreadPoolExecutor(workers) as ex:
        for lo in range(0, n_pos, per):
            block = list(ex.map(lambda i: _draw_row(base, i, shape),
                                range(lo, min(lo + per, n_pos))))
            for i, (g, ok) in enumerate(block, lo):
                if not ok:
                    seq = np.random.Generator(_advanced(base, i * n))
                    for _ in range(i, n_pos):
                        yield seq.gumbel(size=shape).astype(np.float32)
                    return
                yield g


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
        for t, gumbel in enumerate(_gumbel_rows(rng, S, (B, V))):
            logits = self._u[toks[:, t]] @ self._v    # (B, V)
            toks[:, t + 1] = np.argmax(logits / 2.0 + gumbel, axis=-1)
        return self._split(toks)

    def fast_batch_at(self, step: int) -> dict:
        """iid unigram batch (no Markov loop) — for throughput tests."""
        rng = np.random.default_rng((self.seed, step))
        B, S, V = self.batch, self.seq, self.vocab
        z = rng.zipf(1.3, size=(B, S + 1)).clip(1, V) - 1
        return self._split(z.astype(np.int64))
