"""Segmented incremental ANN index for the dynamic tier (port of
``repro/index/segmented.py``).

An LSM-style layout over the dynamic tier's slots:

- **tail**: a fixed-capacity mutable fp32 buffer taking every write at
  O(tail) cost; lookups scan it exactly (one small masked matmul);
- **sealed segments**: a full tail is sealed into an immutable int8
  cluster-major block with the static IVF's packed layout, scanned by
  the same ``kernels/ivf_scan`` band scan (the CUDA kernel on the
  card); its ``row_ids`` hold dynamic-tier slot ids;
- **tombstones**: an overwritten or evicted slot's stale copy is
  tombstoned (row id -> -1), never rewritten in place, so each live
  slot appears in exactly one place; tombstones are buffered on the
  host and flushed as one scatter per segment at the next lookup;
- **compactor**: every ``compact_every`` seals, the sealed segments are
  merged into one (tombstones dropped, clusters re-trained), inline or
  on a compactor thread.

Every lookup reranks the union of candidates (tail top-C + per-segment
band-scan top-C) against the live tier embedding matrix in exact fp32
with the lowest-slot tie rule, so whenever the true best live row
survives into the candidate set the served (score, slot) pair equals
the flat masked scan's. Segment layouts come from this package's
``build_ivf``, whose k-means seeding differs from the reference's, so
only the served results (not the layouts) match the JAX index.
"""
from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.device import get_device
from repro_torch.index.ivf import build_ivf, default_n_clusters
from repro_torch.kernels.ivf_scan.ops import ivf_scan, rerank_exact


def _tail_topc(tail_emb: torch.Tensor, tail_slots: torch.Tensor,
               q: torch.Tensor, c: int) -> torch.Tensor:
    """Top-``c`` tail candidates per query: one masked matmul over the
    fixed-shape tail buffer. Returns (B, c) slot ids (-1 = absent). Only
    the selection happens here, so ``torch.topk``'s tie order does not
    matter: the exact rerank applies the tie rule later."""
    sims = q.to(torch.float32) @ tail_emb.T                  # (B, T)
    sims = torch.where(tail_slots[None, :] >= 0, sims,
                       torch.full_like(sims, float("-inf")))
    _, pos = torch.topk(sims, c, dim=1)
    return tail_slots[pos]


class _Segment:
    """Sealed immutable int8 cluster-major block (ivf_scan layout) whose
    row ids are dynamic-tier slot ids. Mutation = tombstoning only."""

    __slots__ = ("centroids", "codes", "scales", "row_ids", "pos",
                 "live", "pending", "n_clusters", "cap")

    def __init__(self, rows: np.ndarray, slots: np.ndarray, device,
                 n_clusters: Optional[int] = None, iters: int = 4,
                 seed: int = 0):
        n = rows.shape[0]
        k = min(n_clusters or default_n_clusters(n), n)
        ivf = build_ivf(rows, n_clusters=k, iters=iters, seed=seed,
                        corpus_normalized=True, device=device)
        ids = ivf.row_ids.cpu().numpy()                  # (K, cap) -> row
        slot_ids = np.where(ids >= 0, slots[np.clip(ids, 0, None)],
                            -1).astype(np.int32)
        self.centroids = ivf.centroids
        self.codes = ivf.codes
        self.scales = ivf.scales
        self.row_ids = torch.from_numpy(slot_ids).to(device)
        self.n_clusters, self.cap = slot_ids.shape
        kk, cc = np.nonzero(slot_ids >= 0)
        self.pos = {int(s): (int(a), int(b))
                    for s, a, b in zip(slot_ids[kk, cc], kk, cc)}
        self.live = len(self.pos)
        self.pending: list = []          # (k, c) tombstones awaiting flush

    def tombstone(self, slot: int) -> None:
        self.pending.append(self.pos.pop(slot))
        self.live -= 1

    def flush(self) -> None:
        """Land the buffered tombstones in ``row_ids``, in place."""
        if self.pending:
            kk, cc = zip(*self.pending)
            dev = self.row_ids.device
            self.row_ids[torch.tensor(kk, device=dev),
                         torch.tensor(cc, device=dev)] = -1
            self.pending.clear()


class SegmentedIndex:
    """Incrementally updatable ANN over the dynamic tier's slots.

    Taken by the policies as ``dyn_index=`` and by
    ``tiers.dynamic_lookup{,_batch}`` as ``index=``. Protocol:

    - ``topk(queries, emb, k=1)``: queries (B, d) L2-normalized, ``emb``
      the live tier embedding matrix (the exact-rerank corpus); returns
      ((B, k) scores, (B, k) slot ids), equal to the flat masked scan
      whenever the true best live slot survives into the candidate set
      (always with ``nprobe=None``, a full probe, and candidate budgets
      that cover the live set);
    - ``record_write(slot, vec)``: a tier write landed at ``slot``;
    - ``invalidate(slot)``: the slot died without a rewrite (TTL);
    - ``describe()`` / ``stats()``: router telemetry. ``stats()['scans']``
      counts the segment band scans issued, one ``ivf_scan`` call each.

    ``compact_every`` sealed segments are merged into one; with
    ``background=True`` the merge runs on a compactor thread and is
    swapped in atomically (``wait_compaction`` joins it).
    """

    def __init__(self, capacity: int, d: int, *, tail_rows: int = 4096,
                 seg_clusters: Optional[int] = None,
                 nprobe: Optional[int] = 16, n_candidates: int = 64,
                 tail_candidates: int = 32, compact_every: int = 4,
                 kmeans_iters: int = 4, background: bool = False,
                 device=None):
        self.device = get_device(device)
        self.capacity = capacity
        self.d = d
        self.tail_rows = tail_rows
        self.seg_clusters = seg_clusters
        self.nprobe = nprobe                 # None = full probe
        self.n_candidates = n_candidates
        self.tail_candidates = min(tail_candidates, tail_rows)
        self.compact_every = max(2, compact_every)
        self.kmeans_iters = kmeans_iters
        self.background = background

        self._lock = threading.RLock()
        self._vec = np.zeros((capacity, d), np.float32)  # slot -> vector
        self._loc: dict = {}     # slot -> ("tail", pos) | (_Segment, None)
        self._tail_np = np.zeros((tail_rows, d), np.float32)
        self._tail_slots = np.full(tail_rows, -1, np.int32)
        self._tail_count = 0
        self._tail_live = 0
        self._tail_dev = None    # lazily refreshed (emb, slots) on device
        self._segments: list[_Segment] = []
        self._seals = 0
        self._merges = 0
        self._writes = 0
        self._tombstones = 0
        self._scans = 0
        self._compactor: Optional[threading.Thread] = None

    # -- mutation (called under the policy's dyn_lock) ---------------------

    def record_write(self, slot: int, vec) -> None:
        """A tier write landed at ``slot``: supersede any earlier copy."""
        vec = np.asarray(vec, np.float32).reshape(self.d)
        with self._lock:
            self._tombstone(slot)
            if self._tail_count == self.tail_rows:
                self._seal_tail()
            pos = self._tail_count
            self._tail_np[pos] = vec
            self._tail_slots[pos] = slot
            self._tail_count += 1
            self._tail_live += 1
            self._loc[slot] = ("tail", pos)
            self._vec[slot] = vec
            self._tail_dev = None
            self._writes += 1

    def bulk_load(self, slots, vectors) -> None:
        """Seed the index with a live set in one build (the state a
        long-running deployment reaches after compaction). ``slots``
        (n,) distinct slot ids; ``vectors`` (n, d) normalized."""
        slots = np.asarray(slots, np.int32)
        vectors = np.asarray(vectors, np.float32)
        with self._lock:
            for s in slots:
                self._tombstone(int(s))
            seg = _Segment(vectors, slots, self.device,
                           n_clusters=self.seg_clusters,
                           iters=self.kmeans_iters, seed=self._seals)
            for slot in seg.pos:
                self._loc[slot] = (seg, None)
            self._segments.append(seg)
            self._vec[slots] = vectors
            self._writes += len(slots)
            self._seals += 1

    def invalidate(self, slot: int) -> None:
        """Eviction without rewrite (e.g. TTL sweep): tombstone only."""
        with self._lock:
            self._tombstone(slot)

    def _tombstone(self, slot: int) -> None:
        loc = self._loc.pop(slot, None)
        if loc is None:
            return
        where, pos = loc
        if where == "tail":
            self._tail_slots[pos] = -1
            self._tail_live -= 1
            self._tail_dev = None
        else:
            where.tombstone(slot)
        self._tombstones += 1

    # -- sealing + compaction ----------------------------------------------

    def _seal_tail(self) -> None:
        """Freeze the full tail buffer into an int8 sealed segment. Dead
        tail rows (slot -1) are carried into the build and come out
        pre-tombstoned."""
        seg = _Segment(self._tail_np.copy(), self._tail_slots.copy(),
                       self.device, n_clusters=self.seg_clusters,
                       iters=self.kmeans_iters, seed=self._seals)
        for slot in seg.pos:
            self._loc[slot] = (seg, None)
        self._segments.append(seg)
        self._tail_np[:] = 0.0
        self._tail_slots[:] = -1
        self._tail_count = 0
        self._tail_live = 0
        self._tail_dev = None
        self._seals += 1
        if len(self._segments) >= self.compact_every:
            if self.background:
                self._spawn_compactor()
            else:
                self.compact()

    def compact(self) -> None:
        """Merge every sealed segment into one: gather live rows, drop
        tombstones, re-train the cluster layout. Served results do not
        change (the exact rerank scores whatever candidates survive)."""
        with self._lock:
            src = list(self._segments)
        self._merge(src)

    def _spawn_compactor(self) -> None:
        if self._compactor is not None and self._compactor.is_alive():
            return
        src = list(self._segments)
        self._compactor = threading.Thread(
            target=self._merge, args=(src,), daemon=True,
            name="segidx-compactor")
        self._compactor.start()

    def wait_compaction(self, timeout_s: float = 60.0) -> None:
        """Join the compactor thread, if one runs."""
        t = self._compactor
        if t is not None:
            t.join(timeout_s)

    def _merge(self, src: list) -> None:
        if not src:
            return
        with self._lock:
            # snapshot the rows live now; writes racing the build
            # tombstone in src and are re-checked at swap time
            slots = np.asarray(sorted(
                s for s, loc in self._loc.items() if loc[0] in src),
                np.int64)
            rows = self._vec[slots].copy() if len(slots) else None
        if rows is None:
            with self._lock:
                self._segments = [s for s in self._segments
                                  if s not in src]
            return
        merged = _Segment(rows, slots.astype(np.int32), self.device,
                          n_clusters=self.seg_clusters,
                          iters=self.kmeans_iters, seed=self._merges + 1)
        with self._lock:
            for slot in list(merged.pos):
                if self._loc.get(slot, (None,))[0] in src:
                    self._loc[slot] = (merged, None)
                else:        # rewritten or evicted while the build ran
                    merged.tombstone(slot)
            self._segments = [s for s in self._segments
                              if s not in src] + [merged]
            self._merges += 1

    # -- lookup ------------------------------------------------------------

    def _tail_device(self):
        if self._tail_dev is None:
            self._tail_dev = (torch.from_numpy(self._tail_np.copy())
                              .to(self.device),
                              torch.from_numpy(self._tail_slots.copy())
                              .to(self.device))
        return self._tail_dev

    def candidates(self, queries: torch.Tensor) -> Optional[torch.Tensor]:
        """(B, C_total) candidate slot ids across tail + segments
        (-1 = absent); None when the index holds no live entries."""
        with self._lock:
            segs = list(self._segments)
            for seg in segs:
                seg.flush()
            tail_emb, tail_slots = self._tail_device()
            tail_live = self._tail_live
        cands = []
        if tail_live:
            cands.append(_tail_topc(tail_emb, tail_slots, queries,
                                    self.tail_candidates))
        for seg in segs:
            if seg.live == 0:
                continue
            k = seg.n_clusters
            nprobe = k if self.nprobe is None else min(self.nprobe, k)
            nc = min(self.n_candidates, nprobe * seg.cap)
            _, cand = ivf_scan(queries, seg.centroids, seg.codes,
                               seg.scales, seg.row_ids, nprobe=nprobe,
                               n_candidates=nc)
            with self._lock:
                self._scans += 1
            cands.append(cand)
        if not cands:
            return None
        return torch.cat(cands, dim=1)

    def topk(self, queries: torch.Tensor, emb: torch.Tensor, k: int = 1):
        """Exact-reranked top-``k`` live slots. queries (B, d)
        L2-normalized; ``emb`` the live tier embedding matrix (C, d).
        Returns ((B, k) fp32 scores, (B, k) int32 slot ids); queries with
        no live candidate get (-inf, 0), as the flat masked scan."""
        cand = self.candidates(queries)
        B = queries.shape[0]
        if cand is None:
            return (torch.full((B, k), float("-inf"), device=emb.device),
                    torch.zeros((B, k), dtype=torch.int32,
                                device=emb.device))
        vals, idx = rerank_exact(queries, emb, cand,
                                 k=min(k, cand.shape[1]))
        idx = torch.where(idx < 0, 0, idx).to(torch.int32)
        if vals.shape[1] < k:    # fewer candidates than asked: pad absent
            pad = k - vals.shape[1]
            vals = torch.nn.functional.pad(vals, (0, pad),
                                           value=float("-inf"))
            idx = torch.nn.functional.pad(idx, (0, pad))
        return vals, idx

    # -- telemetry ---------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            seg_live = sum(s.live for s in self._segments)
            seg_slots = sum(s.n_clusters * s.cap for s in self._segments)
            return {
                "live": self._tail_live + seg_live,
                "tail_live": self._tail_live,
                "tail_used": self._tail_count,
                "tail_rows": self.tail_rows,
                "segments": len(self._segments),
                "segment_live": seg_live,
                "segment_slots": seg_slots,
                "writes": self._writes,
                "tombstones": self._tombstones,
                "seals": self._seals,
                "merges": self._merges,
                "scans": self._scans,
            }

    def describe(self) -> str:
        s = self.stats()
        probe = "full" if self.nprobe is None else self.nprobe
        return (f"segmented(live={s['live']}, tail={s['tail_live']}/"
                f"{self.tail_rows}, segs={s['segments']}, "
                f"seg_live={s['segment_live']}, nprobe={probe}, "
                f"C={self.n_candidates}, seals={s['seals']}, "
                f"merges={s['merges']})")
