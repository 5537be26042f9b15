"""Exact and IVF top-k over tiers row-sharded across a mesh's devices
(port of ``repro/index/sharded.py``).

The reference runs each lookup under ``shard_map``: every shard scans
its own rows and an ``all_gather`` of the tiny (k scores, k ids)
candidate sets feeds a stable ``lax.top_k`` merge. The port has one
controller and no collectives library: a lookup is a loop over the
shards of a :class:`~repro_torch.launch.mesh.ShardMesh`, each shard's
scan queued on its own device's current stream (at the serving k = 1
the exact scans add no host sync; the IVF scan's cluster selection
checks its ties on the host, as on one device). Each
shard's (B, k) candidates, now with global ids, are copied to the first
shard's device and concatenated in shard order, and the merge keeps the
first k by (score desc, position asc): ``argmax`` for k = 1, a stable
sort otherwise (``torch.topk`` does not order ties). Within a shard the
candidates are already in (score desc, id asc) order, so a tie goes to
the lowest global id, the single-device rule: a fully invalid tier
gives (-inf, 0). The exact static scan cuts a tier of any row count
into blocks with no pad rows (:func:`shard_static_rows`); the IVF
layouts pad with copies of row 0 (:func:`pad_rows`) and tombstone
them, so a pad row is never returned.

The per-shard static scan is the port's ``kernels/simsearch`` (the CUDA
kernel on the card) and the per-shard IVF scan ``kernels/ivf_scan``;
the masked dynamic scan and the retrieval scores are plain matmuls, as
in the reference.

A sharded argument is either one tensor, cut here into row blocks
(:func:`shard_rows`, :func:`shard_static_rows`), or a sequence of
per-shard tensors, each on its shard's device. The shard count is the
mesh's device count. When every shard sits on one device (one card, or
the CPU) the blocks of a tensor already there are views of it
(``narrow``), so the card never holds the static tier twice; when the
mesh spans several devices each block is a copy on its own device, so
no device keeps the whole tensor alive once the caller drops it. The
code path is the same.

Writes (:func:`sharded_dyn_write`, :func:`sharded_bulk_insert`,
:func:`sharded_touch_many`, :func:`sharded_invalidate`) are routed on
the host from host slot values (:func:`_owned_slots`): each lands only
on the shard that owns the slot, and a slot no shard owns (negative or
past the tier) is dropped, as the reference's ``mode="drop"`` scatters
drop it. Nothing gathers the tier to write it.
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.index.flat import l2_normalize
from repro_torch.index.ivf import IVF, build_ivf, ivf_from_numpy
from repro_torch.kernels.ivf_scan.ops import ivf_search
from repro_torch.kernels.simsearch.ops import cosine_topk
from repro_torch.kernels.simsearch.ref import topk_lowest_index


def pad_rows(corpus, n_shards: int):
    """Pad a row-sharded corpus to a multiple of ``n_shards`` rows with
    copies of row 0 (numpy arrays and tensors alike), as the reference
    does. A pad row scores like row 0 only up to rounding, so the port
    never serves one: :class:`ShardedIVFIndex` tombstones its pads and
    the exact scan makes none (:func:`shard_static_rows`). Returns
    ``corpus`` itself when no pad is needed."""
    n = corpus.shape[0]
    pad = (-n) % n_shards
    if pad == 0:
        return corpus
    if isinstance(corpus, np.ndarray):
        return np.concatenate([corpus, np.repeat(corpus[:1], pad, axis=0)])
    return torch.cat([corpus, corpus[:1].expand(pad, *corpus.shape[1:])])


def _place(block: torch.Tensor, mesh, s: int) -> torch.Tensor:
    """Row block ``block`` on shard ``s``'s device: the block itself
    when the mesh has one device, else a copy, so that no device keeps
    the whole source tensor alive through a view of it."""
    return block.to(mesh.devices[s], copy=len(set(mesh.devices)) > 1)


def shard_rows(x, mesh) -> Tuple[torch.Tensor, ...]:
    """The per-shard row blocks of ``x``: a tensor is cut into one equal
    row block a device of the mesh (:func:`_place`); a sequence of
    per-shard tensors is taken as it is."""
    n_shards = len(mesh.devices)
    if not isinstance(x, torch.Tensor):
        parts = tuple(x)
        if len(parts) != n_shards:
            raise ValueError(f"{len(parts)} parts for {n_shards} shards")
        return parts
    if x.shape[0] % n_shards:
        raise ValueError(f"{x.shape[0]} rows do not split into {n_shards} "
                         "shards: pad them first (pad_rows)")
    rows = x.shape[0] // n_shards
    return tuple(_place(x.narrow(0, s * rows, rows), mesh, s)
                 for s in range(n_shards))


def shard_static_rows(emb, mesh) -> Tuple[torch.Tensor, ...]:
    """The static tier's per-shard row blocks with no pad rows: shard
    ``s`` holds the rows ``[s * R, (s + 1) * R)`` of the N, R =
    ceil(N / S), so the trailing blocks may be short or empty. These
    are the blocks :func:`pad_rows` + :func:`shard_rows` give, less the
    pads, and global row ids are the same (``local + s * R``). A
    sequence of per-shard blocks is taken as it is."""
    n_shards = len(mesh.devices)
    if not isinstance(emb, torch.Tensor):
        return shard_rows(emb, mesh)
    n = emb.shape[0]
    rows = -(-n // n_shards)
    return tuple(_place(emb.narrow(0, min(n, s * rows),
                                   max(0, min(rows, n - s * rows))), mesh, s)
                 for s in range(n_shards))


def _padded_blocks(parts) -> Tuple[torch.Tensor, ...]:
    """Short trailing blocks of :func:`shard_static_rows` padded to the
    first block's rows with copies of row 0, as :func:`pad_rows` pads
    (only the short blocks are copied)."""
    rows = parts[0].shape[0]
    row0 = parts[0][:1]
    return tuple(p if p.shape[0] == rows else torch.cat(
        [p, row0.to(p.device).expand(rows - p.shape[0], -1)])
        for p in parts)


def merge_candidates(vals: Sequence[torch.Tensor],
                     ids: Sequence[torch.Tensor], k: int):
    """Per-shard (B, k) candidates, in shard order, -> the first ``k``
    by (score desc, position asc), on the first shard's device. The
    reference's ``all_gather`` + stable ``lax.top_k``."""
    dev = vals[0].device
    v = torch.cat([x.to(dev, non_blocking=True) for x in vals], dim=1)
    i = torch.cat([x.to(dev, non_blocking=True) for x in ids], dim=1)
    if k == 1:
        pos = torch.argmax(v, dim=1, keepdim=True)      # the first maximum
    else:
        pos = torch.sort(v, dim=1, descending=True, stable=True)[1][:, :k]
    return torch.gather(v, 1, pos), torch.gather(i, 1, pos)


@dataclass
class ShardedDynamicTier:
    """A ``tiers.DynamicTier`` row-sharded over a mesh: each field is a
    tuple of per-shard tensors, shard ``s`` holding the global slots
    ``[s * rows_per, (s + 1) * rows_per)`` on the mesh's ``s``-th
    device. A field is a tuple, so code that would write the tier as one
    tensor fails instead of writing a copy."""
    emb: tuple
    cls: tuple
    answer_ref: tuple
    static_origin: tuple
    valid: tuple
    last_used: tuple
    written_at: tuple
    expires_at: tuple

    @property
    def rows_per(self) -> int:
        return self.emb[0].shape[0]


def shard_dynamic_tier(tier, mesh) -> ShardedDynamicTier:
    """Place every field of a ``tiers.DynamicTier`` row-sharded over
    the mesh, so the lookups and writes below run shard-local from the
    start. The capacity must divide into the shard count."""
    n_shards = len(mesh.devices)
    if tier.emb.shape[0] % n_shards:
        raise ValueError(f"capacity {tier.emb.shape[0]} does not split "
                         f"into {n_shards} shards")
    return ShardedDynamicTier(**{
        f.name: shard_rows(getattr(tier, f.name), mesh)
        for f in fields(tier)})


def masked_topk_parts(q: torch.Tensor, emb_parts, valid_parts, k: int = 1):
    """Masked top-k of ``q`` (B, d), as given, over per-shard rows:
    invalid rows score -inf. Returns (scores (B, k), global slot ids
    (B, k) int32). The policies' repair scan over a batch-start tier
    uses it as it is; :func:`sharded_masked_topk` normalizes q first."""
    vals, ids = [], []
    lo = 0
    for e, m in zip(emb_parts, valid_parts):
        qs = q.to(e.device, non_blocking=True)
        sims = torch.where(m[None, :], qs @ e.T,
                           torch.tensor(float("-inf"), device=e.device))
        v, i = topk_lowest_index(sims, k)
        vals.append(v)
        ids.append(i + lo)
        lo += e.shape[0]
    return merge_candidates(vals, ids, k)


def sharded_masked_topk(queries: torch.Tensor, emb, valid, mesh,
                        k: int = 1):
    """Dynamic-tier twin of :func:`sharded_cosine_topk`: masked top-k
    over a row-sharded tier with a global-slot merge. queries (B, d);
    emb (C, d) and valid (C,) row-sharded. Returns (scores
    (B, k), global slot ids (B, k)), equal to
    ``masked_cosine_topk(corpus_normalized=True)``: q is re-normalized
    as there, and each row's score is over the whole d axis. A fully
    invalid tier gives (-inf, 0)."""
    q = l2_normalize(queries.to(torch.float32))
    return masked_topk_parts(q, shard_rows(emb, mesh),
                             shard_rows(valid, mesh), k)


def _owned_slots(slots, shard: int, rows_per: int):
    """Host routing of global slot ids to shard ``shard``: returns the
    positions of the slots it owns and their shard-local rows. A slot
    owned elsewhere, negative or past the tier is no shard's (the
    reference maps it out of range for a dropping scatter; here it is
    left out)."""
    s = np.asarray(slots, np.int64).reshape(-1)
    lo = shard * rows_per
    owned = (s >= lo) & (s < lo + rows_per)
    pos = np.nonzero(owned)[0]
    return pos, s[pos] - lo


def _index(rows: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(rows, dtype=torch.int64, device=device)


def sharded_dyn_write(tier: ShardedDynamicTier, slot, q, cls, answer_ref,
                      static_origin, now, mesh, last_used=None,
                      expires=0) -> ShardedDynamicTier:
    """Shard-routed twin of ``tiers._write``: one slot write landing
    only on the owning shard, in place. ``now`` stamps ``written_at``
    (the LWW clock) and, unless ``last_used`` says otherwise, the LRU
    clock."""
    for s in range(len(mesh.devices)):
        _, local = _owned_slots([int(slot)], s, tier.rows_per)
        if not len(local):
            continue
        r = int(local[0])
        dev = tier.emb[s].device
        tier.emb[s][r] = torch.as_tensor(q, dtype=torch.float32).to(dev)
        tier.cls[s][r] = int(cls)
        tier.answer_ref[s][r] = int(answer_ref)
        tier.static_origin[s][r] = bool(static_origin)
        tier.valid[s][r] = True
        tier.last_used[s][r] = int(now if last_used is None else last_used)
        tier.written_at[s][r] = int(now)
        tier.expires_at[s][r] = int(expires)
    return tier


def sharded_bulk_insert(tier: ShardedDynamicTier, V: torch.Tensor, slots,
                        rows, ts, cls, mesh, exps=None) -> ShardedDynamicTier:
    """Shard-routed twin of the policy's ``_bulk_insert``: a batch's
    backend inserts, one indexed write per field on each owning shard
    (``last_used`` follows through the batch's touch, as on one
    device). ``slots``, ``rows`` (into V), ``ts``, ``cls`` and ``exps``
    are host sequences of one length."""
    slots = np.asarray(slots, np.int64).reshape(-1)
    rows, ts, cls = (np.asarray(a, np.int64).reshape(-1)
                     for a in (rows, ts, cls))
    exps = np.zeros(len(slots), np.int64) if exps is None \
        else np.asarray(exps, np.int64).reshape(-1)
    for s in range(len(mesh.devices)):
        pos, local = _owned_slots(slots, s, tier.rows_per)
        if not len(pos):
            continue
        dev = tier.emb[s].device
        li = _index(local, dev)
        tier.emb[s][li] = V[_index(rows[pos], V.device)].to(dev)
        tier.cls[s][li] = torch.as_tensor(cls[pos], dtype=torch.int32,
                                          device=dev)
        tier.answer_ref[s][li] = -1
        tier.static_origin[s][li] = False
        tier.valid[s][li] = True
        tier.written_at[s][li] = torch.as_tensor(ts[pos], dtype=torch.int32,
                                                 device=dev)
        tier.expires_at[s][li] = torch.as_tensor(exps[pos],
                                                 dtype=torch.int32,
                                                 device=dev)
    return tier


def sharded_touch_many(tier: ShardedDynamicTier, slots, nows,
                       mesh) -> ShardedDynamicTier:
    """Shard-routed twin of ``tiers.touch_many``: the LRU clocks of a
    batch of hits, owner-local. Callers deduplicate ``slots``."""
    nows = np.asarray(nows, np.int64).reshape(-1)
    for s in range(len(mesh.devices)):
        pos, local = _owned_slots(slots, s, tier.rows_per)
        if not len(pos):
            continue
        dev = tier.last_used[s].device
        tier.last_used[s][_index(local, dev)] = torch.as_tensor(
            nows[pos], dtype=torch.int32, device=dev)
    return tier


def sharded_invalidate(tier: ShardedDynamicTier, slots,
                       mesh) -> ShardedDynamicTier:
    """Clear the valid bit and the expiry of ``slots``, owner-local: the
    policies' eager TTL sweep, which the reference writes as one scatter
    into its global view of the sharded tier."""
    for s in range(len(mesh.devices)):
        _, local = _owned_slots(slots, s, tier.rows_per)
        if not len(local):
            continue
        li = _index(local, tier.valid[s].device)
        tier.valid[s][li] = False
        tier.expires_at[s][li] = 0
    return tier


def sharded_cosine_topk(queries: torch.Tensor, corpus, mesh, k: int = 4):
    """Exact cosine top-k over a row-sharded corpus: the
    ``kernels/simsearch`` scan on each shard, then the merge. queries
    (B, d); corpus (N, d) of any row count, cut as
    :func:`shard_static_rows` cuts it, or those per-shard blocks. No
    pad rows are made: a pad copy of row 0 scores like row 0 only up to
    the rounding its place in the scan gets (a CPU matrix-vector product
    gave one an ulp more), so it could not be trusted to lose the tie.
    Returns (scores (B, k), global row ids (B, k) int32)."""
    parts = shard_static_rows(corpus, mesh)
    rows_per = parts[0].shape[0]
    vals, ids = [], []
    for s, c in enumerate(parts):
        if not c.shape[0]:
            continue
        v, i = cosine_topk(queries.to(c.device, non_blocking=True), c,
                           k=min(k, c.shape[0]))
        vals.append(v)
        ids.append(i + s * rows_per)
    return merge_candidates(vals, ids, k)


def mesh_cosine_topk(queries, corpus, k: int = 4):
    """:func:`sharded_cosine_topk` on a ``DeviceMesh`` (the reference's
    production mesh): ``corpus`` a DTensor whose rows are sharded over
    'model' (replicated over the data-parallel axes), ``queries`` (B, d)
    replicated. Each rank scans its rows with the simsearch kernel, its
    (B, k) candidates are all-gathered over 'model' and merged in rank
    order (``merge_candidates``: score desc, position asc). Returns
    replicated DTensors (scores (B, k), global row ids (B, k))."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed.act_sharding import (
        TP_AXIS, from_local, gather_over, mesh_dim, shard_bounds)
    mesh = corpus.device_mesh
    md = mesh_dim(mesh, TP_AXIS)
    rep = [Replicate()] * mesh.ndim
    rows = [Shard(0) if i == md else Replicate() for i in range(mesh.ndim)]
    q = queries.redistribute(mesh, rep).to_local() \
        if hasattr(queries, "device_mesh") else queries
    c = corpus.redistribute(mesh, rows).to_local()
    first, cnt = shard_bounds(mesh, TP_AXIS, corpus.shape[0])
    if cnt < k:
        raise ValueError(f"{cnt} rows a shard < k = {k}")
    v, i = cosine_topk(q, c, k=k)
    n, B = mesh.size(md), q.shape[0]
    all_v = gather_over(v, mesh, TP_AXIS).reshape(n, B, k)
    all_i = gather_over(i.to(torch.int32) + first, mesh,
                        TP_AXIS).reshape(n, B, k)
    vals, ids = merge_candidates(list(all_v.unbind(0)),
                                 list(all_i.unbind(0)), k)
    return (from_local(vals, mesh, rep, (B, k)),
            from_local(ids, mesh, rep, (B, k)))


def _scores(uq: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Raw-dot scores of (B, d) users, or the max over the I interests
    of (B, I, d) users, against candidate rows c (n, d), in fp32."""
    if uq.dim() == 3:
        return torch.einsum("bid,nd->bin", uq, c).amax(dim=1) \
            .to(torch.float32)
    return (uq @ c.T).to(torch.float32)


def sharded_topk_scores(u: torch.Tensor, cand_vecs, cand_ids, mesh,
                        k: int = 100):
    """Distributed retrieval scoring: raw-dot top-k a shard, ties to the
    lowest candidate position, then the merge. u (B, d) or (B, I, d)
    (multi-interest: max over I); cand_vecs (N, d) and cand_ids (N,)
    row-sharded. Returns (scores (B, k), candidate ids)."""
    vals, ids = [], []
    for c, cid in zip(shard_rows(cand_vecs, mesh),
                      shard_rows(cand_ids, mesh)):
        v, i = topk_lowest_index(_scores(u.to(c.device), c), k)
        vals.append(v)
        ids.append(cid[i.long()])
    return merge_candidates(vals, ids, k)


def sharded_topk_local_candidates(u: torch.Tensor, table, cand_ids, mesh,
                                  k: int = 100):
    """Retrieval over range-partitioned candidates: shard ``s`` holds
    the table rows ``[s * V/S, (s + 1) * V/S)`` and a candidate list
    whose ids lie in that range, so the gather is shard-local and only
    the k candidates a shard cross to the merge. table (V, d) and
    cand_ids (N,) row-sharded; an id outside its shard's range
    gathers a clipped row, as in the reference. Returns (scores (B, k),
    candidate ids (B, k))."""
    vals, ids = [], []
    lo = 0
    for tab, cid in zip(shard_rows(table, mesh),
                        shard_rows(cand_ids, mesh)):
        rows = tab.shape[0]
        local = (cid.long() - lo).clamp(0, rows - 1)
        v, i = topk_lowest_index(_scores(u.to(tab.device), tab[local]), k)
        vals.append(v)
        ids.append(cid[i.long()])
        lo += rows
    return merge_candidates(vals, ids, k)


def build_sharded_ivf(corpus, mesh, n_clusters: int | None = None,
                      **build_kw) -> Tuple[IVF, ...]:
    """A sub-index a shard over a row-partitioned corpus: shard ``s``
    owns the contiguous rows ``[s * N/S, (s + 1) * N/S)`` and gets its
    own IVF layout on its device (centroids trained on its rows only,
    local row ids). ``corpus`` is a tensor or an array whose rows divide
    into the shard count, or a sequence of equal per-shard blocks;
    ``build_kw`` go to ``index/ivf.build_ivf``
    (with ``corpus_normalized=True`` a tensor's row blocks become the
    layouts' rerank rows without a copy)."""
    if isinstance(corpus, np.ndarray):
        corpus = torch.from_numpy(np.asarray(corpus, np.float32))
    return tuple(build_ivf(c, n_clusters=n_clusters, device=c.device,
                           **build_kw)
                 for c in shard_rows(corpus, mesh))


def sharded_ivf_from_numpy(centroids, codes, scales, row_ids, corpus,
                           mesh) -> Tuple[IVF, ...]:
    """The port's per-shard layouts from a layout stacked on a leading
    shard axis (the reference's ``build_sharded_ivf``: centroids
    (S, K, d), codes (S, K, cap, d), scales and row_ids (S, K, cap),
    corpus (S, N/S, d)), one ``index/ivf.ivf_from_numpy`` a shard onto
    its device."""
    n_shards = len(mesh.devices)
    if len(centroids) != n_shards:
        raise ValueError(f"a layout of {len(centroids)} shards for "
                         f"{n_shards}")
    return tuple(ivf_from_numpy(centroids[s], codes[s], scales[s],
                                row_ids[s], corpus[s],
                                device=mesh.devices[s])
                 for s in range(n_shards))


def sharded_ivf_topk(queries: torch.Tensor, sivf: Sequence[IVF], mesh,
                     k: int = 1, nprobe: int = 8, n_candidates: int = 32):
    """ANN twin of :func:`sharded_cosine_topk`: the IVF scan
    (``kernels/ivf_scan``) and exact rerank over each shard's own rows,
    then the merge. ``sivf`` holds one layout a shard, each on its
    shard's device, of equal row counts. Returns (scores (B, k), global
    row ids (B, k), -1 where a shard had no candidate)."""
    if len(sivf) != len(mesh.devices):
        raise ValueError(f"{len(sivf)} layouts for {len(mesh.devices)} "
                         "shards")
    rows_per = sivf[0].corpus.shape[0]
    vals, ids = [], []
    for s, ivf in enumerate(sivf):
        v, lids = ivf_search(queries.to(ivf.corpus.device,
                                        non_blocking=True),
                             ivf.corpus, ivf.centroids, ivf.codes,
                             ivf.scales, ivf.row_ids, k=k, nprobe=nprobe,
                             n_candidates=n_candidates)
        vals.append(v)
        ids.append(torch.where(lids >= 0, lids + s * rows_per, -1))
    return merge_candidates(vals, ids, k)


def sharded_ivf_lookup(mesh, sivf, nprobe: int = 8,
                       n_candidates: int = 32):
    """ANN twin of :func:`sharded_static_lookup`: a (queries) ->
    (best_sim, best_idx) closure over per-shard IVF layouts."""
    def lookup(queries):
        v, i = sharded_ivf_topk(queries, sivf, mesh, k=1, nprobe=nprobe,
                                n_candidates=n_candidates)
        return v[:, 0], i[:, 0]
    return lookup


class ShardedIVFIndex:
    """Injectable static-tier index (the ``topk(queries, k)`` +
    ``describe()`` protocol of ``index/ivf.IVFIndex``) serving through
    the per-shard IVF scan, exact rerank and merge.

    ``corpus`` is the static tier's rows: one tensor or array, padded
    to a shard multiple with copies of row 0 (:func:`pad_rows`), or the
    per-shard blocks of :func:`shard_static_rows`, whose short trailing
    blocks are padded alike; with ``corpus_normalized=True`` the full
    blocks become the layouts' rerank rows without a copy. The pad
    rows' layout entries are then tombstoned (row id -1, the scan's
    padding convention), so no ``k`` returns a global id at or past the
    real row count. ``nprobe`` is clamped to the per-shard cluster
    count. ``sivf`` takes per-shard layouts built elsewhere
    (:func:`sharded_ivf_from_numpy`) in place of the build;
    ``n_clusters`` and ``build_kw`` go to :func:`build_sharded_ivf`."""

    def __init__(self, corpus, mesh, nprobe: int = 8,
                 n_candidates: int = 32, n_clusters: int | None = None,
                 sivf: Sequence[IVF] | None = None, **build_kw):
        self.mesh = mesh
        self.n_shards = len(mesh.devices)
        blocks = not isinstance(corpus, (torch.Tensor, np.ndarray))
        if blocks:
            corpus = shard_rows(corpus, mesh)
        self.n_rows = sum(c.shape[0] for c in corpus) if blocks \
            else corpus.shape[0]
        if sivf is None:
            sivf = build_sharded_ivf(
                _padded_blocks(corpus) if blocks
                else pad_rows(corpus, self.n_shards), mesh,
                n_clusters=n_clusters, **build_kw)
        rows_per = sivf[0].corpus.shape[0]
        if rows_per * self.n_shards < self.n_rows:
            raise ValueError(f"layouts of {rows_per} rows a shard do not "
                             f"cover {self.n_rows} rows")
        # tombstone the pad copies (they may span several trailing
        # shards): the scan never returns the row id -1
        self.sivf = tuple(
            ivf._replace(row_ids=torch.where(
                ivf.row_ids + s * rows_per >= self.n_rows, -1,
                ivf.row_ids))
            for s, ivf in enumerate(sivf))
        self.nprobe = min(nprobe, sivf[0].centroids.shape[0])
        self.n_candidates = n_candidates

    def topk(self, queries: torch.Tensor, k: int = 1):
        """queries (B, d) L2-normalized -> (scores (B, k), global row
        ids (B, k))."""
        return sharded_ivf_topk(queries, self.sivf, self.mesh, k=k,
                                nprobe=self.nprobe,
                                n_candidates=self.n_candidates)

    def describe(self) -> str:
        K = int(self.sivf[0].centroids.shape[0])
        return (f"sharded-ivf(N={self.n_rows}, shards={self.n_shards}, "
                f"K/shard={K}, nprobe={self.nprobe}, "
                f"C={self.n_candidates})")


def sharded_static_lookup(mesh, static_emb):
    """A (queries) -> (best_sim, best_idx) closure over a corpus kept
    row-sharded on the mesh's devices (:func:`shard_static_rows`): the
    serving path's static lookup."""
    parts = shard_static_rows(static_emb, mesh)

    def lookup(queries):
        v, i = sharded_cosine_topk(queries, parts, mesh, k=1)
        return v[:, 0], i[:, 0]
    return lookup
