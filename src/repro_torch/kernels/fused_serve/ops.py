"""Public fused serve entries (port of
``repro/kernels/fused_serve/ops.py``).

``fused_serve_probe`` candidates of both tiers in one pass: the CUDA
                      kernel for CUDA tensors, the plain version for CPU
                      ones.
``fused_serve``       probe + exact fp32 rerank of both candidate
                      lists, emitting ``(s_static, h_idx, s_dyn, j)`` per
                      row. The static pair equals ``ivf_search(k=1)``
                      and the dynamic pair equals the policies' masked
                      argmax whenever the true best row or slot survives
                      into the candidate set.
``FusedServe``        the serve-path object that
                      ``core.tiers.serve_lookup_batch`` and
                      ``core.policy`` (``fused=``) take.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.kernels.fused_serve import kernel as _kernel
from repro_torch.kernels.fused_serve.ref import (fused_serve_ref,
                                                 pack_dyn_tiles)
from repro_torch.kernels.ivf_scan.ops import rerank_exact
from repro_torch.kernels.ivf_scan.ref import (_normalize, order_candidates,
                                              select_clusters)


def fused_serve_probe(queries: torch.Tensor, centroids: torch.Tensor,
                      codes: torch.Tensor, scales: torch.Tensor,
                      row_ids: torch.Tensor, dyn_emb: torch.Tensor,
                      dyn_valid: torch.Tensor, nprobe: int = 8,
                      n_candidates: int = 32, n_dyn_candidates: int = 16,
                      dyn_tile: int = 512):
    """Candidates of both tiers. queries (B, d); the packed IVF layout
    (centroids (K, d), codes (K, cap, d) int8, scales, row_ids (K, cap));
    dyn_emb (C, d) fp32; dyn_valid (C,) bool. Returns (static scores
    (B, C), static ids (B, C), dyn scores (B, Cd), dyn slots (B, Cd));
    -1 = absent. A meta tensor takes the CUDA route, the kernel's meta
    branch in place of the kernel."""
    K, cap, _ = codes.shape
    C_dyn = dyn_emb.shape[0]
    nprobe = min(nprobe, K)
    n_candidates = min(n_candidates, nprobe * cap)
    n_dyn_candidates = min(n_dyn_candidates, C_dyn)
    if queries.device.type not in ("cuda", "meta"):
        return fused_serve_ref(queries, centroids, codes, scales, row_ids,
                               dyn_emb, dyn_valid, nprobe, n_candidates,
                               n_dyn_candidates)
    _, cids = select_clusters(queries, centroids, nprobe)
    tiles, tile_ids = pack_dyn_tiles(dyn_emb, dyn_valid,
                                     min(dyn_tile, C_dyn))
    if queries.device.type == "meta":
        return _kernel.fused_serve_meta(_normalize(queries), cids, codes,
                                        tiles, n_candidates,
                                        n_dyn_candidates)
    return _kernel.fused_serve(_normalize(queries), cids.contiguous(),
                               codes, scales, row_ids, tiles, tile_ids,
                               n_candidates, n_dyn_candidates)


def dyn_rerank_exact(queries: torch.Tensor, dyn_emb: torch.Tensor,
                     cand_slots: torch.Tensor):
    """Exact fp32 top-1 over the dynamic candidates. queries (B, d)
    L2-normalized; dyn_emb (C, d) fp32; cand_slots (B, Cd), -1 = absent.
    Returns (score (B,), slot (B,) int32): lowest slot on ties, and
    (-inf, 0) where no candidate is valid, as ``argmax`` over an all
    ``-inf`` row gives."""
    safe = cand_slots.clamp(0, dyn_emb.shape[0] - 1).long()
    rows = dyn_emb[safe].to(torch.float32)                  # (B, Cd, d)
    exact = torch.einsum("bcd,bd->bc", rows, queries)
    exact = torch.where(cand_slots < 0,
                        torch.full_like(exact, float("-inf")), exact)
    s, j = order_candidates(exact, cand_slots, 1)
    s, j = s[:, 0], j[:, 0]
    return s, torch.where(torch.isneginf(s), 0, j).to(torch.int32)


def fused_serve(queries: torch.Tensor, corpus: torch.Tensor,
                centroids: torch.Tensor, codes: torch.Tensor,
                scales: torch.Tensor, row_ids: torch.Tensor,
                dyn_emb: torch.Tensor, dyn_valid: torch.Tensor,
                nprobe: int = 8, n_candidates: int = 32,
                n_dyn_candidates: int = 16, dyn_tile: int = 512):
    """Full fused serve lookup: probe + exact fp32 reranks. Returns
    ``(s_static (B,), h_idx (B,), s_dyn (B,), j (B,))``."""
    _, si, _, di = fused_serve_probe(
        queries, centroids, codes, scales, row_ids, dyn_emb, dyn_valid,
        nprobe=nprobe, n_candidates=n_candidates,
        n_dyn_candidates=n_dyn_candidates, dyn_tile=dyn_tile)
    ss, hi = rerank_exact(queries, corpus, si, k=1)
    sd, j = dyn_rerank_exact(_normalize(queries), dyn_emb, di)
    return ss[:, 0], hi[:, 0], sd, j


@dataclass(frozen=True)
class FusedServe:
    """Serve path that does both tier lookups in one kernel dispatch.
    ``ivf`` is the packed static-tier layout (``index.ivf.IVF``). Taken
    by ``core.tiers.serve_lookup_batch`` and by the policies as
    ``fused=`` (``launch/serve.py --fused``)."""
    ivf: object
    nprobe: int = 8
    n_candidates: int = 32
    n_dyn_candidates: int = 16
    dyn_tile: int = 512

    def lookup(self, queries: torch.Tensor, dyn):
        """queries (B, d) L2-normalized; ``dyn`` a ``DynamicTier``.
        Returns (s_static (B,), h_idx (B,), s_dyn (B,), j (B,))."""
        return fused_serve(queries, self.ivf.corpus, self.ivf.centroids,
                           self.ivf.codes, self.ivf.scales,
                           self.ivf.row_ids, dyn.emb, dyn.valid,
                           nprobe=self.nprobe,
                           n_candidates=self.n_candidates,
                           n_dyn_candidates=self.n_dyn_candidates,
                           dyn_tile=self.dyn_tile)

    def describe(self) -> str:
        K, cap, d = self.ivf.codes.shape
        return (f"fused-serve(N={self.ivf.corpus.shape[0]}, K={K}, "
                f"cap={cap}, d={d}, nprobe={self.nprobe}, "
                f"C={self.n_candidates}, Cd={self.n_dyn_candidates})")
