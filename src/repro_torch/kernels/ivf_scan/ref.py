"""Plain PyTorch version of the IVF band scan (port of
``repro/kernels/ivf_scan/ref.py``).

Scores the probed clusters' int8 codes against the normalized query and
selects the top-C candidates under the kernel's contract: descending
approximate score, ties broken by the lowest *global row id* (not the
position), pad slots (row id -1, score NEG) sinking to the tail.

The dot products are accumulated in fp64 and rounded once to fp32, as
``csrc/ivf_scan.cu`` does: each int8 x fp32 product is exact in fp64,
so the rounded score does not depend on the order of the additions, and
this version and the kernel select the same candidates. Against the
JAX reference's fp32 sums the scores differ by rounding only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.simsearch.ref import topk_lowest_index

NEG = -2.0          # below any cosine similarity; pads score this


def _normalize(q: torch.Tensor) -> torch.Tensor:
    q = q.to(torch.float32)
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                           min=1e-9)


def select_clusters(queries: torch.Tensor, centroids: torch.Tensor,
                    nprobe: int):
    """Centroid scoring: (B, d) x (K, d) -> top-``nprobe`` clusters,
    ties to the lowest cluster id (as ``jax.lax.top_k``). Returns
    (centroid scores (B, nprobe), cluster ids (B, nprobe) int32).
    Shared by this version and the kernel's dispatch, so both scan the
    same clusters."""
    q = _normalize(queries)
    return topk_lowest_index(q @ centroids.to(torch.float32).T, nprobe)


def order_candidates(vals: torch.Tensor, ids: torch.Tensor, n: int):
    """The first ``n`` columns of (B, M) candidates in (value desc,
    id asc) order: a stable sort by id, then a stable sort by value
    (``jnp.lexsort((ids, -vals))``)."""
    by_id = torch.argsort(ids, dim=1, stable=True)
    v = torch.gather(vals, 1, by_id)
    i = torch.gather(ids, 1, by_id)
    by_v = torch.argsort(v, dim=1, descending=True, stable=True)[:, :n]
    return torch.gather(v, 1, by_v), torch.gather(i, 1, by_v)


def dot64(rows: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """fp32 scores of (B, ..., R, d) rows against (B, d) queries, summed
    in fp64 and rounded once (the kernels' arithmetic)."""
    qd = q.to(torch.float64).reshape(q.shape[0], *([1] * (rows.dim() - 3)),
                                     q.shape[1], 1)
    return torch.matmul(rows.to(torch.float64), qd)[..., 0] \
        .to(torch.float32)


def threshold_survivors(vals: torch.Tensor, n: int,
                        bins: int = 256) -> torch.Tensor:
    """Plain mirror of the kernel's threshold step (``select_into`` in
    ``csrc/ivf_band.cuh``), in the card's fp32 arithmetic: the (m,)
    scores are binned linearly between the best score and the worst
    score above NEG (pads), bin 0 the best; the survivors are the keys
    in the first bin at which the count reaches n, or in a better one.
    Returns the (m,) bool mask. Bins are monotone in the score, so the
    best n keys (by score desc, id asc) always survive."""
    v = vals.to(torch.float32)
    vbest = v.max()
    real = v[v > NEG]
    vworst = real.min() if real.numel() else vbest
    if vbest > vworst:
        inv = torch.tensor(float(bins), dtype=torch.float32) / (vbest - vworst)
    else:
        inv = torch.tensor(0.0, dtype=torch.float32)
    t = vbest - v
    b = torch.where(t > 0, torch.clamp(t * inv, max=bins - 1.0),
                    torch.zeros_like(t)).to(torch.int32)
    counts = torch.bincount(b.long(), minlength=bins).cumsum(0)
    bstar = int(torch.nonzero(counts >= n)[0])
    return b <= bstar


def band_scan_ref(qn: torch.Tensor, cids: torch.Tensor,
                  codes: torch.Tensor, scales: torch.Tensor,
                  row_ids: torch.Tensor, n_candidates: int):
    """The kernel's function, plainly: scan the bands ``cids`` (B, nprobe)
    for the L2-normalized queries ``qn`` (B, d) and return the top
    ``n_candidates`` (approx scores (B, C) fp32, row ids (B, C) int32)
    in (score desc, id asc) order, pads as (NEG, -1)."""
    cids = cids.long()
    sims = dot64(codes[cids], qn) * scales[cids]            # (B, P, cap)
    g_ids = row_ids[cids]
    sims = torch.where(g_ids < 0, torch.full_like(sims, NEG), sims)
    B = qn.shape[0]
    flat = g_ids.shape[1] * g_ids.shape[2]   # explicit: B may be 0
    v, i = order_candidates(sims.reshape(B, flat), g_ids.reshape(B, flat),
                            n_candidates)
    return v, i.to(torch.int32)


def ivf_scan_ref(queries: torch.Tensor, centroids: torch.Tensor,
                 codes: torch.Tensor, scales: torch.Tensor,
                 row_ids: torch.Tensor, nprobe: int, n_candidates: int):
    """Reference IVF scan.

    queries (B, d); centroids (K, d) normalized; codes (K, cap, d) int8;
    scales (K, cap) fp32; row_ids (K, cap) int32 (-1 = pad slot).
    Returns (approx scores (B, C) fp32, candidate row ids (B, C) int32);
    absent candidates have score NEG and id -1."""
    _, cids = select_clusters(queries, centroids, nprobe)   # (B, P)
    return band_scan_ref(_normalize(queries), cids, codes, scales,
                         row_ids, n_candidates)
