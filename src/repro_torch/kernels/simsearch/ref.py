"""Plain PyTorch version of the fused simsearch kernel."""
from __future__ import annotations

import torch


def topk_lowest_index(sims: torch.Tensor, k: int):
    """Top-k along the last axis, ordered by (value desc, index asc).

    ``torch.topk`` leaves the order of ties unspecified; a stable
    descending sort keeps equal values in index order, and ``argmax``
    returns the first maximum. Returns (values, int32 indices)."""
    if k == 1:
        idx = torch.argmax(sims, dim=-1, keepdim=True)
        return torch.gather(sims, -1, idx), idx.to(torch.int32)
    vals, idx = torch.sort(sims, dim=-1, descending=True, stable=True)
    return vals[..., :k].contiguous(), idx[..., :k].to(torch.int32)


def simsearch_ref(queries: torch.Tensor, corpus: torch.Tensor, k: int):
    """Cosine-similarity top-k.

    queries (B, d), corpus (N, d), neither pre-normalized. Returns
    (scores (B, k) fp32, idx (B, k) int32); ties go to the lowest index.
    """
    q = queries.to(torch.float32)
    c = corpus.to(torch.float32)
    q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                        min=1e-9)
    c = c / torch.clamp(torch.linalg.vector_norm(c, dim=-1, keepdim=True),
                        min=1e-9)
    return topk_lowest_index(q @ c.T, k)
