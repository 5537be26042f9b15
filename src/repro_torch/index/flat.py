"""Exact flat vector index: normalize + matmul + top-k.

Port of ``repro/index/flat.py``. The plain functions here are the
oracle twins of the fused ``kernels/simsearch`` path, which
:class:`FlatIndex` serves through. Top-k ties go to the lowest index
(``kernels/simsearch/ref.topk_lowest_index``), as ``jax.lax.top_k``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.simsearch.ref import topk_lowest_index


def l2_normalize(x: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=eps)


def cosine_topk(queries: torch.Tensor, corpus: torch.Tensor, k: int = 1,
                corpus_normalized: bool = False):
    """Cosine similarity top-k. queries (B, d), corpus (N, d) ->
    (scores (B, k), idx (B, k))."""
    q = l2_normalize(queries.to(torch.float32))
    c = corpus.to(torch.float32)
    if not corpus_normalized:
        c = l2_normalize(c)
    return topk_lowest_index(q @ c.T, k)


def masked_cosine_topk(queries: torch.Tensor, corpus: torch.Tensor,
                       valid: torch.Tensor, k: int = 1,
                       corpus_normalized: bool = False):
    """Cosine top-k over a partially valid corpus (the dynamic tier):
    invalid rows score -inf. ``valid`` (N,) bool."""
    q = l2_normalize(queries.to(torch.float32))
    c = corpus.to(torch.float32)
    if not corpus_normalized:
        c = l2_normalize(c)
    sims = torch.where(valid[None, :], q @ c.T,
                       torch.tensor(float("-inf"), device=q.device))
    return topk_lowest_index(sims, k)


class FlatIndex:
    """Exact flat search behind the index protocol (``topk(queries, k)``
    + ``describe()``), served by the fused ``kernels/simsearch`` path
    over a fixed corpus. The fused path re-normalizes internally on
    every call; ``corpus_normalized`` only skips the one-time
    normalization here."""

    def __init__(self, corpus: torch.Tensor, corpus_normalized: bool = False):
        c = corpus.to(torch.float32)
        self.corpus = (c if corpus_normalized else l2_normalize(c)) \
            .contiguous()

    def topk(self, queries: torch.Tensor, k: int = 1):
        """queries (B, d) L2-normalized -> (scores (B, k), idx (B, k))."""
        from repro_torch.kernels.simsearch.ops import cosine_topk as fused
        return fused(queries, self.corpus, k=k)

    def describe(self) -> str:
        n, d = self.corpus.shape
        return f"flat(N={n}, d={d})"
