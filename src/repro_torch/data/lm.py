"""LM data: synthetic corpora, packing and deterministic batching, the
token side of the LM zoo's training input.

A copy of the JAX package's ``data/lm.py`` (plain numpy, no JAX), kept so
the port never imports that package: the same seeds give the same arrays,
bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np


def markov_corpus(vocab: int, n_tokens: int, seed: int = 0,
                  alpha: float = 0.3) -> np.ndarray:
    """Synthetic corpus with learnable bigram structure (a dense Dirichlet
    transition matrix) — perplexity decreases under real training."""
    rng = np.random.default_rng(seed)
    # sparse-ish rows: zipfian support keeps the matrix memory-sane
    support = min(vocab, 64)
    probs = rng.dirichlet([alpha] * support, size=vocab)
    cols = np.stack([rng.choice(vocab, size=support, replace=False)
                     for _ in range(min(vocab, 4096))])
    if vocab > 4096:   # share column patterns above 4k states
        cols = cols[rng.integers(0, 4096, size=vocab)]
    out = np.empty(n_tokens, np.int32)
    s = int(rng.integers(0, vocab))
    for i in range(n_tokens):
        out[i] = s
        s = int(cols[s][rng.choice(support, p=probs[s])])
    return out


def copy_task_corpus(vocab: int, n_tokens: int, span: int = 8,
                     seed: int = 0) -> np.ndarray:
    """Repeat-after-me structure: spans are emitted twice — induction-head
    fodder; any architecture with working memory should exploit it."""
    rng = np.random.default_rng(seed)
    out = []
    while sum(len(c) for c in out) < n_tokens:
        s = rng.integers(0, vocab, size=span)
        out.append(np.concatenate([s, s]))
    return np.concatenate(out)[:n_tokens].astype(np.int32)


def pack_sequences(tokens: np.ndarray, seq_len: int) -> np.ndarray:
    """Pack a flat token stream into (N, seq_len) rows (drop remainder)."""
    n = len(tokens) // seq_len
    return tokens[:n * seq_len].reshape(n, seq_len)


@dataclass
class LMDataset:
    rows: np.ndarray          # (N, seq_len) int32
    vocab: int

    def batches(self, batch: int, *, seed: int = 0,
                epochs: int | None = None) -> Iterator[dict]:
        """Deterministic shuffled batches: {'tokens': (B, S)}."""
        rng = np.random.default_rng(seed)
        N = len(self.rows)
        epoch = 0
        while epochs is None or epoch < epochs:
            order = rng.permutation(N)
            for i in range(0, N - batch + 1, batch):
                yield {"tokens": self.rows[order[i:i + batch]]}
            epoch += 1


def make_lm_dataset(vocab: int, *, seq_len: int = 128, n_tokens: int = 200_000,
                    kind: str = "markov", seed: int = 0) -> LMDataset:
    gen = markov_corpus if kind == "markov" else copy_task_corpus
    return LMDataset(pack_sequences(gen(vocab, n_tokens, seed=seed), seq_len),
                     vocab)
