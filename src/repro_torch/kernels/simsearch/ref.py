"""Plain PyTorch version of the fused simsearch kernel."""
from __future__ import annotations

import torch


def topk_lowest_index(sims: torch.Tensor, k: int):
    """Top-k along the last axis, ordered by (value desc, index asc).

    ``argmax`` returns the first maximum. For k > 1, ``torch.topk`` picks
    the values but leaves the order of ties unspecified, so the rows
    where a tie could change the choice or the order (a repeated value
    among the k, or more than k values at or above the k-th) are redone
    with a stable descending sort, which keeps equal values in index
    order; the other rows never pay for sorting whole. Returns (values,
    int32 indices)."""
    if k == 1:
        idx = torch.argmax(sims, dim=-1, keepdim=True)
        return torch.gather(sims, -1, idx), idx.to(torch.int32)
    flat = sims.reshape(-1, sims.shape[-1])
    vals, idx = torch.topk(flat, k, dim=-1)
    ties = ((flat >= vals[:, -1:]).sum(-1) > k) \
        | (vals[:, 1:] == vals[:, :-1]).any(-1)
    if bool(ties.any()):
        rows = ties.nonzero()[:, 0]
        v, i = torch.sort(flat[rows], dim=-1, descending=True, stable=True)
        vals[rows] = v[:, :k]
        idx[rows] = i[:, :k]
    shape = (*sims.shape[:-1], k)
    return vals.reshape(shape), idx.to(torch.int32).reshape(shape)


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
