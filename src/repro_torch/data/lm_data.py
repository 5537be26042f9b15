"""Synthetic LM token pipeline (no corpora to load; a numpy copy of
``repro/data/lm_data.py``: for the same arguments and seed it yields the
same arrays).

Generates a learnable mixture so short training runs show decreasing
loss: Zipfian unigrams + deterministic bigram continuation rules + copy
spans. Yields {"tokens", "labels"} batches with next-token labels.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np


def synthetic_lm_batches(vocab_size: int, batch: int, seq_len: int,
                         seed: int = 0) -> Iterator[dict]:
    rng = np.random.default_rng(seed)
    # deterministic successor table: makes sequences predictable
    succ = rng.integers(3, vocab_size, size=vocab_size)
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    probs = ranks ** -1.1
    probs /= probs.sum()

    while True:
        toks = np.empty((batch, seq_len), np.int32)
        for b in range(batch):
            seq = [int(rng.choice(vocab_size, p=probs))]
            while len(seq) < seq_len:
                if rng.random() < 0.75:
                    seq.append(int(succ[seq[-1]]))       # learnable rule
                else:
                    seq.append(int(rng.choice(vocab_size, p=probs)))
            toks[b] = seq[:seq_len]
        labels = np.concatenate(
            [toks[:, 1:], np.full((batch, 1), -1, np.int32)], axis=1)
        yield {"tokens": toks, "labels": labels}
