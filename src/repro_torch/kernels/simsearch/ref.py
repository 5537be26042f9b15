"""Plain PyTorch version of the fused simsearch kernel, and of the
kernel's screen-then-rescore schedule."""
from __future__ import annotations

import torch

SCREEN_EPS = 2.0 ** -8   # csrc/simsearch.cu's screening margin


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


def tf32_truncate(x: torch.Tensor) -> torch.Tensor:
    """fp32 values with the 13 low mantissa bits cleared: TF32 by
    truncation, the coarsest rounding the tensor cores may apply."""
    return (x.to(torch.float32).contiguous().view(torch.int32)
            & ~0x1FFF).view(torch.float32)


def simsearch_screened_ref(queries: torch.Tensor, corpus: torch.Tensor,
                           k: int, eps: float = SCREEN_EPS):
    """The CUDA kernel's schedule in plain PyTorch: every (query, row)
    cosine is screened from TF32-truncated operands, and only the rows
    whose screened score lies within ``eps`` of the query's k-th best
    exact score are scored exactly; the top-k of those is returned.
    Returns (scores (B, k), int32 idx (B, k), screened (B, N) scores,
    exact (B, N) scores, kept (B, N) bool). The result equals
    :func:`simsearch_ref`'s whenever the screening error stays below
    ``eps``, which the kernel's note proves for d <= 1024."""
    q = queries.to(torch.float32)
    c = corpus.to(torch.float32)
    q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                        min=1e-9)
    inv = 1.0 / torch.clamp(torch.linalg.vector_norm(c, dim=-1), min=1e-9)
    screened = (tf32_truncate(q) @ tf32_truncate(c).T) * inv
    exact = q @ (c * inv[:, None]).T
    kth = topk_lowest_index(exact, k)[0][:, -1:]
    kept = screened >= kth - eps
    vals, idx = topk_lowest_index(torch.where(kept, exact, -torch.inf), k)
    return vals, idx, screened, exact, kept
