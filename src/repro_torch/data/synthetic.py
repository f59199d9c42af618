"""Deterministic synthetic corpus with learnable structure.

No WikiText/Alpaca exists offline, so every experiment that needs text runs
on a Zipf-Markov language: Zipfian unigram marginals (natural-language-like
token frequencies) + a sparse first-order Markov transition structure
(k likely successors per token) + an in-context copy process (spans repeat
later in the sequence, giving attention something only context can solve).
A model that learns the transitions and the copy rule drops well below the
unigram-entropy floor, so pruning-quality differences show up exactly as
they would on real text perplexity.

Fully deterministic given (vocab, seed): corpus regeneration is exact across
hosts — the data-parallel pipeline shards by slicing the batch axis, no
files needed.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class SyntheticCorpus:
    vocab_size: int
    seed: int = 0
    n_successors: int = 8          # sparse Markov out-degree
    zipf_a: float = 1.2
    copy_prob: float = 0.15        # per-position chance to start a copy span
    copy_len: int = 8
    smoothing: float = 0.05        # uniform mixture (keeps support full)

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        V = self.vocab_size
        ranks = np.arange(1, V + 1, dtype=np.float64)
        self.unigram = ranks ** (-self.zipf_a)
        self.unigram /= self.unigram.sum()
        # each token's successor set + Zipf-weighted transition probs
        self.succ = rng.integers(0, V, size=(V, self.n_successors))
        w = np.arange(1, self.n_successors + 1, dtype=np.float64) ** (-1.0)
        self.succ_p = w / w.sum()

    def sample_tokens(self, rng: np.random.Generator, batch: int,
                      seq: int) -> np.ndarray:
        V = self.vocab_size
        out = np.empty((batch, seq), np.int64)
        out[:, 0] = rng.choice(V, size=batch, p=self.unigram)
        # vectorized Markov walk with uniform smoothing
        for t in range(1, seq):
            prev = out[:, t - 1]
            pick = rng.choice(self.n_successors, size=batch, p=self.succ_p)
            nxt = self.succ[prev, pick]
            smooth = rng.random(batch) < self.smoothing
            nxt[smooth] = rng.choice(V, size=smooth.sum(), p=self.unigram)
            out[:, t] = nxt
        # overlay copy spans: out[:, t:t+L] = out[:, s:s+L] for earlier s
        n_spans = int(self.copy_prob * seq / self.copy_len)
        for b in range(batch):
            for _ in range(n_spans):
                L = self.copy_len
                if seq < 3 * L:
                    break
                dst = rng.integers(2 * L, seq - L)
                src = rng.integers(0, dst - L)
                out[b, dst:dst + L] = out[b, src:src + L]
        return out.astype(np.int32)

    def batch(self, batch: int, seq: int, *, split: str = "train",
              index: int = 0) -> Dict[str, np.ndarray]:
        """Deterministic batch #`index` of a named split."""
        salt = {"train": 1, "eval": 2, "calib": 3}[split]
        rng = np.random.default_rng((self.seed, salt, index))
        toks = self.sample_tokens(rng, batch, seq)
        return {"tokens": toks, "labels": toks.copy()}


def batch_iterator(corpus: SyntheticCorpus, batch: int, seq: int, *,
                   split: str = "train", start: int = 0,
                   extra: Optional[Dict] = None) -> Iterator[Dict]:
    """Stateless infinite iterator — step-indexed so a restarted trainer
    resumes at the exact batch it crashed on."""
    i = start
    while True:
        b = corpus.batch(batch, seq, split=split, index=i)
        if extra:
            b.update(extra)
        yield b
        i += 1
