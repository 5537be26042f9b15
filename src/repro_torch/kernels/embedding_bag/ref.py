"""Plain PyTorch version of the embedding-bag kernel."""
from __future__ import annotations

import torch


def embedding_bag_ref(table: torch.Tensor, ids: torch.Tensor,
                      weights: torch.Tensor) -> torch.Tensor:
    """Weighted bag reduce: table (V, d), ids (B, m), weights (B, m).

    Returns (B, d) fp32 = sum_j weights[b, j] * table[ids[b, j]] (mean
    mode = weights 1/count; masked entries = weight 0). The sum runs
    over j in order from zero, one fp32 multiply and one fp32 add a
    step, as the TPU kernel accumulates (``kernel.py:22-31``); the CUDA
    kernel rounds the same way, so on the card the two agree bit for
    bit."""
    B, m = ids.shape
    w = weights.to(torch.float32)
    acc = torch.zeros((B, table.shape[1]), dtype=torch.float32,
                      device=table.device)
    for j in range(m):
        acc = acc + w[:, j, None] * table[ids[:, j].long()].to(torch.float32)
    return acc
