"""Plain PyTorch version of the fused simsearch kernel, and of the
kernel's screen-then-rescore schedule."""
from __future__ import annotations

import torch

SCREEN_EPS = 2.0 ** -8   # csrc/simsearch.cu's screening margin


def topk_lowest_index(sims: torch.Tensor, k: int):
    """Top-k along the last axis, ordered by (value desc, index asc).

    ``argmax`` returns the first maximum. For k > 1, ``torch.topk``
    leaves the order of ties unspecified, so on fp32 it runs on distinct
    int64 keys instead: the value's bits mapped to an integer of the
    same order (-0.0 taken as +0.0, which compares equal to it) in the
    high 32 bits, and N - 1 - index in the low 32, so that among equal
    values the lowest index is the largest key; another dtype takes a
    stable descending sort. Either way the result depends on no value
    read back to the host (no sync, and it runs on meta tensors).
    Returns (values, int32 indices)."""
    if k == 1:
        idx = torch.argmax(sims, dim=-1, keepdim=True)
        return torch.gather(sims, -1, idx), idx.to(torch.int32)
    if sims.dtype != torch.float32:
        vals, idx = torch.sort(sims, dim=-1, descending=True, stable=True)
        return vals[..., :k], idx[..., :k].to(torch.int32)
    N = sims.shape[-1]
    bits = (sims + 0.0).view(torch.int32)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    low = torch.arange(N - 1, -1, -1, dtype=torch.int64, device=sims.device)
    _, idx = torch.topk(ordered.to(torch.int64) * 2 ** 32 + low, k, dim=-1)
    return torch.gather(sims, -1, idx), idx.to(torch.int32)


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
