"""Public IVF scan entries (port of ``repro/kernels/ivf_scan/ops.py``).

``ivf_scan``     centroid selection + probed-band int8 scan, emitting the
                 top-C (approx score, global row id) candidates: the CUDA
                 kernel for CUDA tensors, the plain version for CPU ones.
``rerank_exact`` exact fp32 rerank of the candidates against the
                 normalized corpus rows, ties to the lowest global id.
``ivf_search``   scan + rerank; the (B, k) twin of
                 ``kernels.simsearch.ops.cosine_topk``. Whenever the true
                 best row is among the candidates (recall@C) the served
                 pair equals flat search's.

Centroid selection (a (B, K) fp32 matmul) and the rerank (a gather of C
rows, an fp32 dot and a stable sort) run outside any kernel here, as
they do in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ivf_scan import kernel as _kernel
from repro_torch.kernels.ivf_scan.ref import (_normalize, ivf_scan_ref,
                                              order_candidates,
                                              select_clusters)


def ivf_scan(queries: torch.Tensor, centroids: torch.Tensor,
             codes: torch.Tensor, scales: torch.Tensor,
             row_ids: torch.Tensor, nprobe: int = 8,
             n_candidates: int = 32):
    """Approximate candidates over the packed IVF layout.

    queries (B, d); centroids (K, d); codes (K, cap, d) int8; scales
    (K, cap); row_ids (K, cap), -1 = pad. ``nprobe`` is clamped to K
    and ``n_candidates`` to nprobe * cap. Returns (approx scores (B, C),
    global row ids (B, C) int32, -1 = absent). A meta tensor takes the
    CUDA route, the kernel's meta branch in place of the kernel."""
    K, cap, _ = codes.shape
    nprobe = min(nprobe, K)
    n_candidates = min(n_candidates, nprobe * cap)
    if queries.device.type not in ("cuda", "meta"):
        return ivf_scan_ref(queries, centroids, codes, scales, row_ids,
                            nprobe, n_candidates)
    _, cids = select_clusters(queries, centroids, nprobe)
    if queries.device.type == "meta":
        return _kernel.ivf_scan_meta(_normalize(queries), cids, codes,
                                     n_candidates)
    return _kernel.ivf_scan(_normalize(queries), cids.contiguous(), codes,
                            scales, row_ids, n_candidates)


def rerank_exact(queries: torch.Tensor, corpus: torch.Tensor,
                 cand_ids: torch.Tensor, k: int):
    """Exact fp32 rerank of scan candidates. queries (B, d); corpus
    (N, d) L2-normalized fp32; cand_ids (B, C), -1 = absent. Returns
    (scores (B, k), ids (B, k) int32) by (score desc, id asc); absent
    candidates score -inf."""
    if k > cand_ids.shape[1]:
        raise ValueError(f"rerank k={k} exceeds candidate count "
                         f"{cand_ids.shape[1]}")
    q = _normalize(queries)
    safe = cand_ids.clamp(0, corpus.shape[0] - 1).long()
    rows = corpus[safe].to(torch.float32)                   # (B, C, d)
    exact = torch.einsum("bcd,bd->bc", rows, q)
    exact = torch.where(cand_ids < 0,
                        torch.full_like(exact, float("-inf")), exact)
    v, i = order_candidates(exact, cand_ids, k)
    return v, i.to(torch.int32)


def ivf_search(queries: torch.Tensor, corpus: torch.Tensor,
               centroids: torch.Tensor, codes: torch.Tensor,
               scales: torch.Tensor, row_ids: torch.Tensor, k: int = 1,
               nprobe: int = 8, n_candidates: int = 32):
    """IVF scan + exact rerank. ``k`` must not exceed the effective
    candidate count (``n_candidates`` after the nprobe * cap clamp):
    returning fewer than k columns would break fixed-shape callers."""
    K, cap, _ = codes.shape
    effective_c = min(n_candidates, min(nprobe, K) * cap)
    if k > effective_c:
        raise ValueError(f"k={k} exceeds candidate budget {effective_c} "
                         f"(n_candidates={n_candidates}, nprobe={nprobe}, "
                         f"cap={cap})")
    _, cand = ivf_scan(queries, centroids, codes, scales, row_ids,
                       nprobe=nprobe, n_candidates=n_candidates)
    return rerank_exact(queries, corpus, cand, k)
