"""Synthetic click-log generator for the recsys models (a numpy copy of
``repro/data/recsys_data.py``: for the same ``(cfg, batch, seed)`` it
yields the same arrays)."""
from __future__ import annotations

from typing import Iterator

import numpy as np

from repro_torch.configs.base import RecSysConfig


def recsys_batches(cfg: RecSysConfig, batch: int,
                   seed: int = 0) -> Iterator[dict]:
    rng = np.random.default_rng(seed)
    n_items = cfg.n_items

    def zipf_items(shape):
        u = rng.random(shape)
        return (1 + (n_items - 1) * u ** 2.0).astype(np.int32)

    while True:
        if cfg.kind == "sasrec":
            seq = zipf_items((batch, cfg.seq_len))
            pos = np.roll(seq, -1, 1)
            pos[:, -1] = zipf_items((batch,))
            yield {"seq": seq, "pos": pos,
                   "neg": zipf_items((batch, cfg.seq_len))}
        elif cfg.kind == "mind":
            yield {"seq": zipf_items((batch, cfg.seq_len)),
                   "pos": zipf_items((batch,)),
                   "neg": zipf_items((batch, 16))}
        elif cfg.kind == "bst":
            seq = zipf_items((batch, cfg.seq_len))
            target = zipf_items((batch,))
            # clickable iff target appears in recent history (learnable)
            label = (np.abs(seq[:, -1] - target) < n_items // 10) \
                .astype(np.float32)
            yield {"seq": seq, "target": target, "label": label}
        else:  # wide_deep
            ids = rng.integers(0, cfg.sparse_vocab,
                               (batch, cfg.n_sparse, cfg.multi_hot)) \
                .astype(np.int32)
            mask = rng.random(ids.shape) < 0.8
            logit = (ids[:, 0, 0] % 7 < 3)
            yield {"sparse_ids": ids, "sparse_mask": mask,
                   "label": logit.astype(np.float32)}
