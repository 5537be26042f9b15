"""Plain PyTorch version of the fused two-tier probe (port of
``repro/kernels/fused_serve/ref.py``).

The static half is ``ivf_scan_ref`` itself. The dynamic half mirrors the
kernel's precision: tier rows round to bf16 (round to nearest even, the
streamed tile type) before the dot against the normalized query, which
is summed in fp64 and rounded once to fp32 as ``csrc/fused_serve.cu``
does; invalid slots score NEG with id -1, and the top-``Cd`` candidates
come out in (score desc, slot asc) order with absent ones as (NEG, -1).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ivf_scan.ref import (NEG, _normalize,
                                              band_scan_ref, ivf_scan_ref,
                                              order_candidates)


def pack_dyn_tiles(dyn_emb: torch.Tensor, dyn_valid: torch.Tensor,
                   tile: int):
    """Tile the dynamic tier for the kernel: (C, d) fp32 -> ((T, tile, d)
    bf16 tiles, (T, tile) int32 slot ids, -1 where the slot is invalid
    or padding). Capacity is padded up to a tile multiple with id -1
    rows, which the kernel masks like invalid slots."""
    C, d = dyn_emb.shape
    ids = torch.where(dyn_valid,
                      torch.arange(C, dtype=torch.int32,
                                   device=dyn_emb.device),
                      torch.full((C,), -1, dtype=torch.int32,
                                 device=dyn_emb.device))
    pad = (-C) % tile
    emb = F.pad(dyn_emb, (0, 0, 0, pad)).to(torch.bfloat16)
    ids = F.pad(ids, (0, pad), value=-1)
    T = (C + pad) // tile
    return emb.reshape(T, tile, d), ids.reshape(T, tile)


def dyn_scan_ref(queries: torch.Tensor, dyn_emb: torch.Tensor,
                 dyn_valid: torch.Tensor, n_dyn_candidates: int):
    """Reference dynamic-tier candidate scan. queries (B, d); dyn_emb
    (C, d) fp32 (valid rows L2-normalized); dyn_valid (C,) bool. Returns
    (approx scores (B, Cd) fp32, tier slots (B, Cd) int32)."""
    C = dyn_emb.shape[0]
    return tile_scan_ref(_normalize(queries),
                         *pack_dyn_tiles(dyn_emb, dyn_valid, C),
                         min(n_dyn_candidates, C))


def tile_scan_ref(qn: torch.Tensor, tiles: torch.Tensor,
                  tile_ids: torch.Tensor, n_dyn_candidates: int):
    """The kernel's dynamic half, plainly: (T, tile, d) bf16 tiles with
    (T, tile) slot ids (-1 = invalid or pad) against the L2-normalized
    queries ``qn`` (B, d). Returns the top ``n_dyn_candidates``
    (scores (B, Cd) fp32, slots (B, Cd) int32), absent as (NEG, -1)."""
    e = tiles.reshape(-1, tiles.shape[-1]).to(torch.float64)
    ids = tile_ids.reshape(-1)
    sims = (qn.to(torch.float64) @ e.T).to(torch.float32)
    sims = torch.where(ids[None, :] < 0, torch.full_like(sims, NEG), sims)
    vals, cand = order_candidates(sims, ids[None, :].expand_as(sims),
                                  n_dyn_candidates)
    return vals, torch.where(vals == NEG, -1, cand).to(torch.int32)


def fused_kernel_ref(qn, cids, codes, scales, row_ids, tiles, tile_ids,
                     n_candidates: int, n_dyn_candidates: int):
    """Plain version of ``kernel.fused_serve``, with its signature."""
    return (*band_scan_ref(qn, cids, codes, scales, row_ids, n_candidates),
            *tile_scan_ref(qn, tiles, tile_ids, n_dyn_candidates))


def fused_serve_ref(queries: torch.Tensor, centroids: torch.Tensor,
                    codes: torch.Tensor, scales: torch.Tensor,
                    row_ids: torch.Tensor, dyn_emb: torch.Tensor,
                    dyn_valid: torch.Tensor, nprobe: int,
                    n_candidates: int, n_dyn_candidates: int):
    """Reference fused probe: static IVF scan + dynamic masked scan.
    Returns (static scores (B, C), static global ids (B, C), dyn scores
    (B, Cd), dyn tier slots (B, Cd)) under the kernel's clamps
    (nprobe <= K, C <= nprobe * cap, Cd <= capacity)."""
    K, cap, _ = codes.shape
    nprobe = min(nprobe, K)
    n_candidates = min(n_candidates, nprobe * cap)
    sv, si = ivf_scan_ref(queries, centroids, codes, scales, row_ids,
                          nprobe, n_candidates)
    dv, di = dyn_scan_ref(queries, dyn_emb, dyn_valid, n_dyn_candidates)
    return sv, si, dv, di
