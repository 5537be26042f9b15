"""Live (host-level) tiered semantic cache policies.

Port of ``repro/core/policy.py``:

``BaselinePolicy`` = Algorithm 1 (static thresholds over a static and a
                     dynamic tier);
``KritesPolicy``   = Algorithm 2: the same serving path plus the
                     grey-zone trigger feeding the async VerifyAndPromote
                     pool.

Two serving entry points share one decision procedure: ``serve(prompt)``
(scalar) and ``serve_batch(prompts)``, the batched hot path, which embeds
the micro-batch at once, does ONE static-tier top-1 and ONE masked
dynamic-tier top-1, then resolves rows in request order so results equal
calling ``serve`` per row. The static lookup is the fused exact
``kernels/simsearch`` scan, or an injected ``index=`` (``IVFIndex``:
the ``kernels/ivf_scan`` band scan + exact rerank); the dynamic lookup
is a masked matmul, or an injected ``dyn_index=`` (``SegmentedIndex``,
or the string ``"segmented"``). ``fused=`` (``FusedServe``) replaces
both with one ``kernels/fused_serve`` dispatch. Misses go to the backend
as one batch and the batch's tier writes land as one scatter at the
end.

Operability, as in the reference:

- ``l1=`` (an ``ExactTier`` or an int capacity) is an exact-match front
  probed on the canonical prompt before the embedder, and
  ``freshness=`` (a ``FreshnessPolicy``) adds the volatile bypass,
  per-class TTLs and stale accounting; rows either resolves never reach
  the lookups;
- ``adaptive=`` (an ``AdaptiveController``) supplies live per-segment
  thresholds, read under ``dyn_lock``, and adapts them by shadow sweeps;
- ``wal=`` (a ``PromotionWAL``) journals each applied promotion before
  its upsert;
- ``rewriter=`` resolves REWRITE verdicts into tailored answers promoted
  under the query's key (served as ``"rewritten"``).

Sharded serving: ``mesh=`` (a ``launch/mesh.ShardMesh``) row-shards
both tiers over the mesh's devices; the policy then holds the static
rows only as per-shard blocks (``index/sharded.shard_static_rows``), a
copy on each card when the mesh spans several. ``shard_axis=`` is the
reference's keyword and must name the mesh's axis. The static top-1
runs through ``index/sharded.sharded_cosine_topk`` (or an injected
``ShardedIVFIndex``), the dynamic top-1 through the row-sharded masked
scan with a global-slot merge, and every tier write is routed on the
host to the shard that owns the slot. The decision logic and the host
mirrors are unchanged, so decisions equal the single-device path's: the
merge keeps the lowest-index tie rule. ``dyn_index=`` and ``fused=``
refuse a mesh, as in the reference.

The policy keeps host mirrors of the dynamic tier's decision metadata
(valid / last_used / static_origin / written_at / expires_at /
rewritten) so per-row bookkeeping never costs a device round-trip; every
mutation path updates both under ``dyn_lock``. The dynamic tier is
updated IN PLACE (``core/tiers.py``), where the JAX policy swaps in a
new pytree.
"""
from __future__ import annotations

import dataclasses
import functools
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import adaptive as A
from repro_torch.core import tiers as T
from repro_torch.core.async_queue import VerifyAndPromotePool
from repro_torch.core.exact_tier import ExactTier, canonicalize
from repro_torch.core.judge import APPROVE, REJECT, REWRITE, Verdict, \
    as_verdict
from repro_torch.core.promo_wal import encode_record
from repro_torch.device import get_device
from repro_torch.index.flat import l2_normalize, masked_cosine_topk

_BIG = np.int64(2**30)   # host twin of tiers.BIG (LRU key for invalid rows)


def _masked_dyn_topk(emb, valid, q):
    """Dynamic-tier top-1 through the masked index path; tier rows are
    L2-normalized on insert, so ``corpus_normalized=True``. A plain
    masked matmul + argmax: the tier holds a few hundred rows and the
    JAX reference computes it outside any Pallas kernel too."""
    vals, idx = masked_cosine_topk(q, emb, valid, k=1,
                                   corpus_normalized=True)
    return vals[:, 0], idx[:, 0]


def _bulk_insert(dyn: T.DynamicTier, V, slots, rows, ts, cls, exps
                 ) -> T.DynamicTier:
    """Scatter a batch's inserts into the tier in place, one indexed
    write per field (``last_used`` follows through ``touch_many``)."""
    dev = dyn.emb.device
    sl = torch.as_tensor(slots, dtype=torch.int64, device=dev)
    dyn.emb[sl] = V[torch.as_tensor(rows, dtype=torch.int64, device=dev)]
    dyn.cls[sl] = torch.as_tensor(cls, dtype=torch.int32, device=dev)
    dyn.answer_ref[sl] = -1
    dyn.static_origin[sl] = False
    dyn.valid[sl] = True
    dyn.written_at[sl] = torch.as_tensor(ts, dtype=torch.int32, device=dev)
    dyn.expires_at[sl] = torch.as_tensor(exps, dtype=torch.int32,
                                         device=dev)
    return dyn


def _usable_rows(V_np: np.ndarray) -> np.ndarray:
    """Which rows of an already-normalized (B, d) block are servable
    cache keys: finite, and of unit norm (a zero embedding normalizes to
    zero, and a non-finite key inserted into the tier would poison every
    later argmax over it)."""
    return np.isfinite(V_np).all(axis=-1) \
        & (np.linalg.norm(V_np, axis=-1) > 0.5)


@dataclass
class ServeResult:
    answer: object
    served_by: str   # 'l1' | 'static' | 'dynamic' | 'rewritten' | 'backend'
    static_origin: bool
    similarity: float
    latency_s: float
    # freshness flags: "stale": True (a volatile hit whose content
    # predates the drift epoch), "bypass": "volatile" (backend only)
    meta: dict = field(default_factory=dict)


class BaselinePolicy:
    """Algorithm 1. The dynamic tier is guarded by a lock so async
    promotions (Krites subclass) can't race the serving loop."""

    def __init__(self, cfg: T.CacheConfig, static_tier: T.StaticTier,
                 static_answers, embed_fn: Callable,
                 backend_fn: Callable, d: int, *,
                 embed_batch_fn: Optional[Callable] = None,
                 backend_batch_fn: Optional[Callable] = None,
                 index=None, dyn_index=None, static_texts=None,
                 mesh=None, shard_axis: str = "model", fused=None,
                 l1=None, freshness=None, adaptive=None, device=None):
        # the reference's keyword: the port's mesh is 1-D and names its
        # own axis
        if mesh is not None and shard_axis != mesh.axis:
            raise ValueError(f"shard_axis={shard_axis!r}: the mesh's axis "
                             f"is {mesh.axis!r}")
        # a mesh's first device is the policy's unless the caller says
        self.device = get_device(mesh.devices[0] if device is None
                                 and mesh is not None else device)
        if mesh is None and static_tier.emb.device != self.device:
            raise ValueError(f"static tier on {static_tier.emb.device}, "
                             f"policy on {self.device}")
        self.cfg = cfg
        self.static = static_tier
        # online threshold controller (core/adaptive.py): every serving
        # path reads its live per-segment (tau_static, tau_dynamic)
        # under dyn_lock; None (or a frozen controller) serves exactly as
        # the pinned cfg values do
        self.adaptive = adaptive
        # L1 exact-match front (an ExactTier, an int capacity or None),
        # probed on the canonical prompt before the embedder
        self.l1 = ExactTier(capacity=l1) if isinstance(l1, int) else l1
        # staleness-risk layer (core/freshness.py): volatile bypass,
        # per-class TTLs, drift clock for stale accounting
        self.freshness = freshness
        self._l1_hits = 0
        self._l1_bypass = 0
        self._stale_serves = 0
        # injectable static-tier index (FlatIndex/IVFIndex); None = the
        # exact fused flat scan
        self.index = index
        # fused serve path (kernels/fused_serve): ONE dispatch for the
        # static IVF probe and the masked dynamic top-1. It replaces both
        # lookups, so combining it with another index would shadow that
        # index's semantics.
        if fused is not None and (index is not None
                                  or dyn_index is not None
                                  or mesh is not None):
            raise ValueError(
                "fused= replaces both tier lookups; it cannot be "
                "combined with index=, dyn_index= or mesh=")
        self.fused = fused
        # injectable dynamic-tier index (SegmentedIndex); None = the
        # exact masked scan. "segmented" builds the default one.
        if dyn_index == "segmented":
            from repro_torch.index.segmented import SegmentedIndex
            dyn_index = SegmentedIndex(cfg.capacity, d, device=self.device)
        self.dyn_index = dyn_index
        self.static_answers = static_answers
        # prompt texts of the curated entries, row-aligned: the judge
        # verifies on the (q_text, h_text, answer) triple
        self.static_texts = list(static_texts) if static_texts is not None \
            else None
        self.embed_fn = embed_fn
        self.backend_fn = backend_fn
        self.embed_batch_fn = embed_batch_fn
        self.backend_batch_fn = backend_batch_fn
        self.mesh = mesh
        self.dyn = T.make_dynamic_tier(cfg.capacity, d, device=self.device)
        self.dyn_answers: list = [None] * cfg.capacity
        self.dyn_lock = threading.Lock()
        self.t = 0
        self.events: list = []
        self._ttl_evictions = 0
        # flips True at the first write that stamps a finite expiry; the
        # eager expiry sweep is a no-op until then
        self._ttl_active = False
        # host copies of the (immutable) static-tier metadata
        self._static_ref_np = static_tier.answer_ref.cpu().numpy()
        self._static_cls_np = static_tier.cls.cpu().numpy()
        # host mirrors of the dynamic tier's decision metadata
        self._valid_np = np.zeros(cfg.capacity, bool)
        self._last_used_np = np.zeros(cfg.capacity, np.int64)
        self._static_origin_np = np.zeros(cfg.capacity, bool)
        self._written_at_np = np.zeros(cfg.capacity, np.int64)
        self._expires_np = np.zeros(cfg.capacity, np.int64)
        # rewrite provenance: True for entries whose answer is a
        # REWRITE-verdict tailored variant (device twin: answer_ref == -2)
        self._rewritten_np = np.zeros(cfg.capacity, bool)
        if mesh is None:
            self._touch_many = T.touch_many
            self._bulk_insert_fn = _bulk_insert
            self._write_fn = T._write
        else:
            self._init_mesh()

    def _init_mesh(self) -> None:
        """Mesh mode: place the dynamic tier row-sharded and swap every
        lookup and write for its shard-routed twin
        (``index/sharded.py``). The host mirrors and the decision logic
        are unchanged, which keeps sharded serving decision-identical to
        the single-device path."""
        from repro_torch.index import sharded as Sh
        mesh = self.mesh
        n_shards = len(mesh.devices)
        if self.dyn_index is not None:
            raise ValueError(
                "dyn_index + mesh is not supported: the segmented index "
                "reranks against a host-managed layout; the sharded "
                "dynamic path is the exact row-sharded masked scan")
        if self.cfg.capacity % n_shards:
            raise ValueError(f"capacity {self.cfg.capacity} does not "
                             f"split into {n_shards} shards")
        # the static rows as per-shard blocks, no pad rows
        # (shard_static_rows): views of the tier where the mesh has one
        # device, else a copy on each shard's device, and the policy
        # keeps no whole-tier tensor. An injected index (ShardedIVFIndex)
        # owns the static lookup instead.
        self.static = dataclasses.replace(
            self.static, emb=Sh.shard_static_rows(self.static.emb, mesh))
        self.dyn = Sh.shard_dynamic_tier(self.dyn, mesh)
        self._touch_many = functools.partial(Sh.sharded_touch_many,
                                             mesh=mesh)
        self._bulk_insert_fn = functools.partial(Sh.sharded_bulk_insert,
                                                 mesh=mesh)
        self._write_fn = functools.partial(Sh.sharded_dyn_write, mesh=mesh)

    def _invalidate(self, slots) -> None:
        """Clear the valid bit and the expiry of ``slots`` in the tier
        (each on its owning shard under a mesh)."""
        if self.mesh is not None:
            from repro_torch.index.sharded import sharded_invalidate
            sharded_invalidate(self.dyn, slots, self.mesh)
            return
        idx = torch.as_tensor(np.asarray(slots), dtype=torch.int64,
                              device=self.device)
        self.dyn.valid[idx] = False
        self.dyn.expires_at[idx] = 0

    def _serve_static(self, idx: int):
        return self.static_answers[int(self._static_ref_np[idx])]

    def _static_topk_batch(self, V: torch.Tensor):
        """Static-tier top-1 for a (B, d) block: the injected index, the
        row-sharded exact scan, or the fused simsearch kernel (its plain
        version on the CPU)."""
        if self.index is None and self.mesh is not None:
            return T.static_lookup_batch(self.static, V, mesh=self.mesh)
        return T.static_lookup_batch(self.static, V, index=self.index)

    def _dyn_topk(self, dyn: T.DynamicTier, q: torch.Tensor):
        """Dynamic-tier top-1 for a (B, d) block: the injected segmented
        index, its row-sharded masked scan, or the exact masked
        matmul."""
        if self.dyn_index is not None:
            vals, idx = self.dyn_index.topk(q, dyn.emb, k=1)
            return vals[:, 0], idx[:, 0]
        if self.mesh is not None:
            return T.dynamic_lookup_batch(dyn, q, mesh=self.mesh)
        return _masked_dyn_topk(dyn.emb, dyn.valid, q)

    def _host_lru_slot(self) -> int:
        """Host twin of tiers._lru_slot over the mirrored metadata."""
        key = np.where(self._valid_np, self._last_used_np, -_BIG)
        return int(key.argmin())

    # ------------------------------------------------------------------
    # adaptive thresholds (core/adaptive.py)
    # ------------------------------------------------------------------

    def _live_taus(self, prompt: str, *, locked: bool = False):
        """The (tau_static, tau_dynamic, segment) this request serves
        under: the controller's live per-segment point, or the pinned
        cfg values (segment -1) without a controller. The pair is read
        under ``dyn_lock`` (``locked``: the caller holds it)."""
        if self.adaptive is None:
            return self.cfg.tau_static, self.cfg.tau_dynamic, -1
        seg = A.segment_of(prompt)
        if locked:
            return (self.adaptive.tau_static[seg],
                    self.adaptive.tau_dynamic[seg], seg)
        with self.dyn_lock:
            return (self.adaptive.tau_static[seg],
                    self.adaptive.tau_dynamic[seg], seg)

    def _adapt_record(self, v_np, meta, h_idx, seg, res,
                      *, locked: bool = False) -> None:
        """Append a served semantic request to the controller window;
        its label starts as ``meta['cls']`` (else the static neighbor's
        class) and judge verdicts / feedback rewrite it later through
        the seq stamped into ``res.meta['adapt_seq']``."""
        if self.adaptive is None or seg < 0:
            return
        label = int((meta or {}).get("cls", -1))
        if label < 0:
            label = int(self._static_cls_np[h_idx])
        if locked:
            seq = self.adaptive.record(v_np, label, seg)
        else:
            with self.dyn_lock:
                seq = self.adaptive.record(v_np, label, seg)
        res.meta["adapt_seq"] = seq
        res.meta["segment"] = seg

    def _maybe_adapt(self) -> None:
        """Serve-call-boundary adaptation check, with ``dyn_lock``
        released: the controller snapshots and installs under the lock
        and runs the shadow sweep outside it. The scalar path checks
        after every request, the batched path once per batch."""
        if self.adaptive is not None:
            self.adaptive.maybe_adapt(self.dyn_lock, self.static.emb,
                                      self.static.cls)

    # -- hooks for Krites (no-ops in the baseline) -------------------------
    def _after_static_miss(self, prompt, v, h_idx, s_static, res, meta,
                           tau_s=None):
        return

    def _after_static_miss_batch(self, rows) -> None:
        return

    def _embed_one(self, prompt: str) -> torch.Tensor:
        return l2_normalize(torch.as_tensor(
            np.asarray(self.embed_fn(prompt), np.float32)).to(self.device))

    def serve(self, prompt: str, meta: Optional[dict] = None) -> ServeResult:
        """Scalar serving entry (Algorithm 1, plus Algorithm 2's grey-zone
        trigger in the Krites subclass). With ``freshness=`` / ``l1=``
        two stages sit in front of the semantic path: the volatile bypass
        (backend only: no L1, no embed, no lookup, no write-back, no
        grey trigger) and the L1 probe (an exact repeat skips the
        embedder and both lookups). Every non-bypassed outcome is written
        back to L1 with its freshness-class expiry."""
        t0 = time.monotonic()
        self.t += 1
        volatile = self._is_volatile(prompt)
        if volatile and self.freshness.volatile_bypass:
            self._l1_bypass += 1
            res = ServeResult(self.backend_fn(prompt), "backend", False,
                              0.0, time.monotonic() - t0,
                              meta={"bypass": "volatile"})
            self.events.append((res.served_by, res.static_origin))
            self._maybe_adapt()
            return res
        key = None
        if self.l1 is not None:
            key = canonicalize(prompt)
            e = self.l1.get(key, self.t)
            if e is not None:
                self._l1_hits += 1
                res = ServeResult(e.answer, "l1", e.static_origin, 1.0,
                                  time.monotonic() - t0)
                self._mark_stale(res, volatile, e.content_t, self.t)
                self.events.append((res.served_by, res.static_origin))
                self._maybe_adapt()
                return res
        res, content_t = self._serve_semantic(prompt, meta, t0)
        self._mark_stale(res, volatile, content_t, self.t)
        if self.l1 is not None:
            self.l1.put(key, res.answer, static_origin=res.static_origin,
                        content_t=content_t,
                        expires_at=self._entry_expiry(prompt, self.t),
                        now=self.t)
        self._maybe_adapt()
        return res

    def _serve_semantic(self, prompt: str, meta: Optional[dict],
                        t0: float):
        """The semantic decision for one request at tick ``self.t``.
        Returns ``(ServeResult, content_t)``: the served answer's
        generation time for drift accounting (0 for curated static
        answers, the entry's ``written_at`` for dynamic hits, now for
        backend answers)."""
        v = self._embed_one(prompt)
        v_np = v.cpu().numpy()
        if not _usable_rows(v_np[None])[0]:
            # degenerate embedding: backend without caching and without
            # a grey trigger (a promotion would insert the same key)
            res = ServeResult(self.backend_fn(prompt), "backend", False,
                              0.0, time.monotonic() - t0)
            self.events.append((res.served_by, res.static_origin))
            return res, self.t
        tau_s, tau_d, seg = self._live_taus(prompt)
        content_t = self.t        # backend answers are generated now
        if self.fused is None:
            if self.index is not None:
                sv, si = self.index.topk(v[None], 1)
                s_s, h_idx = sv[0, 0], si[0, 0]
            elif self.mesh is not None:
                sv, si = self._static_topk_batch(v[None])
                s_s, h_idx = sv[0], si[0]
            else:
                s_s, h_idx = T.static_lookup(self.static, v)
            s_s, h_idx = float(s_s), int(h_idx)
            if s_s >= tau_s:
                res = ServeResult(self._serve_static(h_idx), "static",
                                  True, s_s, time.monotonic() - t0)
                self._adapt_record(v_np, meta, h_idx, seg, res)
                self.events.append((res.served_by, res.static_origin))
                return res, 0

        with self.dyn_lock:
            self._sweep_expired_locked(self.t)
            if self.fused is not None:
                # both tier lookups in one dispatch, under the lock so a
                # touch lands on the tier the lookup scanned
                ssb, hib, sdb, jdb = T.serve_lookup_batch(
                    self.static, self.dyn, v[None], self.fused)
                s_s, h_idx = float(ssb[0]), int(hib[0])
                sd, jd = sdb, jdb
            else:
                sd, jd = self._dyn_topk(self.dyn, v[None])
            s_d, j = float(sd[0]), int(jd[0])
            res = None
            if s_s < tau_s and s_d >= tau_d:
                if self.mesh is None:
                    T.touch(self.dyn, j, self.t)
                else:   # owner-local scatter, batch-shaped
                    self._touch_many(self.dyn, [j], [self.t])
                self._last_used_np[j] = self.t
                content_t = int(self._written_at_np[j])
                by = "rewritten" if self._rewritten_np[j] else "dynamic"
                res = ServeResult(self.dyn_answers[j], by,
                                  bool(self._static_origin_np[j]), s_d,
                                  time.monotonic() - t0)
        if s_s >= tau_s:        # the fused path decides the static hit here
            res = ServeResult(self._serve_static(h_idx), "static", True,
                              s_s, time.monotonic() - t0)
            self._adapt_record(v_np, meta, h_idx, seg, res)
            self.events.append((res.served_by, res.static_origin))
            return res, 0

        if res is None:
            answer = self.backend_fn(prompt)   # outside the lock
            exp = self._entry_expiry(prompt, self.t)
            with self.dyn_lock:
                slot = self._host_lru_slot()
                self._write_fn(self.dyn, slot, v,
                               (meta or {}).get("cls", -1), -1, False,
                               self.t, expires=exp)
                self._mirror_write(slot, self.t, static_origin=False,
                                   expires=exp)
                if self.dyn_index is not None:
                    self.dyn_index.record_write(slot, v_np)
                self.dyn_answers[slot] = answer
            content_t = self.t
            res = ServeResult(answer, "backend", False, s_d,
                              time.monotonic() - t0)

        self._adapt_record(v_np, meta, h_idx, seg, res)
        self.events.append((res.served_by, res.static_origin))
        # Alg. 2 line 13: grey-zone test on EVERY static miss, against
        # the live tau_static this decision used
        self._after_static_miss(prompt, v_np, h_idx, s_s, res, meta, tau_s)
        return res, content_t

    def _mirror_write(self, slot: int, now: int, static_origin: bool,
                      written_at: Optional[int] = None,
                      expires: int = 0, rewritten: bool = False):
        """Host twin of a tier row write. ``now`` is the LRU clock;
        ``written_at`` (the LWW clock) defaults to it, async promotions
        pass their enqueue time; ``rewritten`` marks a REWRITE variant."""
        self._valid_np[slot] = True
        self._last_used_np[slot] = now
        self._static_origin_np[slot] = static_origin
        self._written_at_np[slot] = now if written_at is None \
            else written_at
        self._expires_np[slot] = expires
        self._rewritten_np[slot] = rewritten
        if expires > 0:
            self._ttl_active = True

    # ------------------------------------------------------------------
    # freshness layer
    # ------------------------------------------------------------------

    def _sweep_expired_locked(self, now: int) -> int:
        """Eagerly invalidate dynamic-tier entries past ``expires_at``
        (expired iff ``now > expires_at > 0``), under ``dyn_lock``.
        Returns how many entries died."""
        if not self._ttl_active:
            return 0
        dead = np.nonzero(self._valid_np & (self._expires_np > 0)
                          & (self._expires_np < now))[0]
        if len(dead) == 0:
            return 0
        self._valid_np[dead] = False
        self._expires_np[dead] = 0
        self._rewritten_np[dead] = False
        self._invalidate(dead)
        for s in dead:
            if self.dyn_index is not None:
                self.dyn_index.invalidate(int(s))
            self.dyn_answers[int(s)] = None
        self._ttl_evictions += len(dead)
        return len(dead)

    def _is_volatile(self, prompt: str) -> bool:
        return self.freshness is not None \
            and self.freshness.is_volatile(prompt)

    def _entry_expiry(self, prompt: str, now: int) -> int:
        """Per-entry expiry stamp for a cache write at tick ``now``: the
        freshness policy's class TTL, else the global ``cfg.ttl``
        (0 = never)."""
        if self.freshness is not None:
            return self.freshness.expires_at(prompt, now)
        return now + self.cfg.ttl if self.cfg.ttl > 0 else 0

    def _mark_stale(self, res: ServeResult, volatile: bool,
                    content_t: int, now: int) -> None:
        """Drift-clock stale accounting for a served hit (never for
        backend answers, which are fresh)."""
        if self.freshness is None or res.served_by == "backend":
            return
        if self.freshness.is_stale(volatile, content_t, now):
            res.meta["stale"] = True
            self._stale_serves += 1

    # ------------------------------------------------------------------
    # batched serving path
    # ------------------------------------------------------------------

    def _embed_batch(self, prompts: Sequence[str]) -> torch.Tensor:
        if self.embed_batch_fn is not None:
            emb = self.embed_batch_fn(prompts)
        else:
            batch = getattr(self.embed_fn, "batch", None)
            emb = batch(list(prompts)) if batch is not None else \
                np.stack([np.asarray(self.embed_fn(p)) for p in prompts])
        return l2_normalize(torch.as_tensor(
            np.asarray(emb, np.float32)).to(self.device))

    def _backend_batch(self, prompts: List[str]) -> List[object]:
        if self.backend_batch_fn is not None:
            return list(self.backend_batch_fn(prompts))
        return [self.backend_fn(p) for p in prompts]

    def _snap_best_excluding(self, snap: T.DynamicTier, v, exclude):
        """Masked top-1 over the batch-start tier with ``exclude``d slots
        removed: the rare repair when an intra-batch insert evicts the
        snapshot argmax of a later row."""
        excl = np.zeros(self.cfg.capacity, bool)
        excl[list(exclude)] = True
        if self.mesh is not None:
            from repro_torch.index.sharded import masked_topk_parts
            rows = snap.rows_per
            ok = [m & torch.as_tensor(~excl[s * rows:(s + 1) * rows],
                                      device=m.device)
                  for s, m in enumerate(snap.valid)]
            sv, sj = masked_topk_parts(v[None], snap.emb, ok, k=1)
            return float(sv[0, 0]), int(sj[0, 0])
        ok = snap.valid & torch.as_tensor(~excl, device=self.device)
        sims = torch.where(ok, snap.emb @ v,
                           torch.tensor(float("-inf"), device=self.device))
        j = int(torch.argmax(sims))
        return float(sims[j]), j

    def _front(self, prompts: Sequence[str]):
        """Resolve volatile-bypass and L1 rows before the embedder runs.
        Returns (front, keys, vol, exp_of): ``front`` maps a row to
        ("bypass",), ("hit", entry) or ("dup", producer row) for an
        in-batch repeat of a row still to be served; ticks are assigned
        in request order, as the scalar path does."""
        fresh = self.freshness
        B = len(prompts)
        front: dict = {}
        keys: List[Optional[str]] = [None] * B
        vol = [False] * B
        exp_of = [0] * B     # L1 expiry stamp for producer rows
        if fresh is None and self.l1 is None:
            return front, keys, vol, exp_of
        pend: dict = {}      # canon key -> (producer row, expires_at)
        for i in range(B):
            ti = self.t + i + 1
            volatile = fresh is not None and fresh.is_volatile(prompts[i])
            vol[i] = volatile
            if volatile and fresh.volatile_bypass:
                front[i] = ("bypass",)
                continue
            if self.l1 is None:
                continue
            k = canonicalize(prompts[i])
            keys[i] = k
            e = self.l1.get(k, ti)
            if e is not None:
                front[i] = ("hit", e)
            elif k in pend and (pend[k][1] == 0 or ti <= pend[k][1]):
                front[i] = ("dup", pend[k][0])
            else:
                exp_of[i] = self._entry_expiry(prompts[i], ti)
                pend[k] = (i, exp_of[i])
        return front, keys, vol, exp_of

    def serve_batch(self, prompts: Sequence[str],
                    metas: Optional[Sequence[Optional[dict]]] = None
                    ) -> List[ServeResult]:
        """Serve a micro-batch. Equivalent, request for request, to
        calling :meth:`serve` on each prompt in order (same answers,
        served_by, static_origin and promotions).

        Volatile-bypass rows and L1 hits are resolved before the
        embedder (``_front``); only the remaining rows are embedded and
        looked up, in one static and one dynamic lookup of exactly that
        many rows. L1 write-backs land at the end of the batch, so under
        L1 capacity pressure within one batch the L1's LRU order can
        differ from scalar serving (semantic decisions never do).

        The dynamic-tier lock is held for the whole batch (backend call
        included), so concurrent promotions land between batches. The
        tier's device writes are deferred to the end of the batch, so
        the lookups and repairs inside the loop all read the batch-start
        tier. If the batched backend call raises, the batch's inserts
        are rolled back and the exception propagates; hits decided
        before the failure keep their LRU touches."""
        if not prompts:
            return []
        t0 = time.monotonic()
        B = len(prompts)
        metas = list(metas) if metas is not None else [None] * B
        front, keys, vol, exp_of = self._front(prompts)
        sem = [i for i in range(B) if i not in front]
        pos_of = {i: p for p, i in enumerate(sem)}

        V = V_np = ok = s_sb = h_idxb = None
        if sem:
            V = self._embed_batch([prompts[i] for i in sem])   # (Bs, d)
            # degenerate-embedding guard: zero out unusable rows so one
            # NaN can't leak through the lookups; served backend-only
            ok = _usable_rows(V.cpu().numpy())
            if not ok.all():
                V = torch.where(torch.as_tensor(ok, device=self.device)
                                [:, None], V,
                                torch.zeros((), device=self.device))
            V_np = V.cpu().numpy()
            if self.fused is None:
                s_sb, h_idxb = self._static_topk_batch(V)      # top-1
                s_sb, h_idxb = s_sb.cpu().numpy(), h_idxb.cpu().numpy()

        results: List[Optional[ServeResult]] = [None] * B
        content_of = [0] * B    # per-row content clock (drift accounting)
        grey_rows = []          # static-miss rows, for the Krites hook
        l1_dup_fill = []        # (row, producer row): answer arrives late
        ev0 = len(self.events)  # rollback point: a failed batch serves
        with self.dyn_lock:     # nobody, so it must record no events
            snap = self.dyn     # unchanged until _apply_batch_writes
            if sem:
                if self.fused is not None:
                    # static probe + masked dynamic top-1 in ONE dispatch
                    s_sb, h_idxb, s_db, j_db = (
                        x.cpu().numpy() for x in T.serve_lookup_batch(
                            self.static, snap, V, self.fused))
                else:
                    s_db, j_db = self._dyn_topk(snap, V)
                    s_db, j_db = s_db.cpu().numpy(), j_db.cpu().numpy()

            written: dict = {}   # slot -> (row, pos) of its last writer
            w_meta: dict = {}    # slot -> (pos, t, cls, exp) bulk write
            saved: dict = {}     # slot -> pre-write mirror state (rollback)
            touched: set = set()
            excl: set = set()    # snapshot rows invalidated this batch
            dead: set = set()    # slots TTL-expired mid-batch
            backend_rows: List[int] = []
            backend_slots: List[int] = []
            deferred = []        # (row, producer row)

            for i in range(B):
                self.t += 1
                ti = self.t
                f = front.get(i)
                if f is not None:
                    if f[0] == "bypass":
                        self._l1_bypass += 1
                        backend_rows.append(i)
                        backend_slots.append(-1)
                        results[i] = ServeResult(
                            None, "backend", False, 0.0, 0.0,
                            meta={"bypass": "volatile"})
                        self.events.append(("backend", False))
                    else:
                        if f[0] == "hit":
                            answer, origin = f[1].answer, f[1].static_origin
                            content_of[i] = f[1].content_t
                        else:   # in-batch duplicate of a producer row
                            p = f[1]
                            answer = results[p].answer
                            origin = results[p].static_origin
                            content_of[i] = content_of[p]
                            if answer is None:
                                l1_dup_fill.append((i, p))
                        self._l1_hits += 1
                        results[i] = ServeResult(answer, "l1", origin, 1.0,
                                                 0.0)
                        self._mark_stale(results[i], vol[i], content_of[i],
                                         ti)
                        self.events.append(("l1", origin))
                    continue
                pos = pos_of[i]
                if not ok[pos]:
                    # backend-only: slot sentinel -1 skips the cache write
                    backend_rows.append(i)
                    backend_slots.append(-1)
                    results[i] = ServeResult(None, "backend", False,
                                             0.0, 0.0)
                    content_of[i] = ti
                    self.events.append(("backend", False))
                    continue
                ss_i, h_i = float(s_sb[pos]), int(h_idxb[pos])
                tau_si, tau_di, seg_i = self._live_taus(prompts[i],
                                                        locked=True)
                if ss_i >= tau_si:
                    results[i] = ServeResult(self._serve_static(h_i),
                                             "static", True, ss_i, 0.0)
                    self._adapt_record(V_np[pos], metas[i], h_i, seg_i,
                                       results[i], locked=True)
                    self._mark_stale(results[i], vol[i], 0, ti)
                    self.events.append(("static", True))
                    continue

                # eager TTL expiry at this row's tick: mirrors flip now,
                # the device scatter is deferred to batch end
                if self._ttl_active:
                    newly = np.nonzero(
                        self._valid_np & (self._expires_np > 0)
                        & (self._expires_np < ti))[0]
                    for s in newly:
                        s = int(s)
                        self._valid_np[s] = False
                        self._expires_np[s] = 0
                        self._rewritten_np[s] = False
                        if self.dyn_index is not None:
                            self.dyn_index.invalidate(s)
                        self.dyn_answers[s] = None
                        written.pop(s, None)
                        dead.add(s)
                        excl.add(s)
                    self._ttl_evictions += len(newly)

                # dynamic candidate = snapshot best, repaired for slots
                # overwritten/expired this batch, merged with intra-batch
                # inserts
                s_d, j = float(s_db[pos]), int(j_db[pos])
                if j in excl:
                    s_d, j = self._snap_best_excluding(snap, V[pos], excl)
                for slot, (_, wpos) in written.items():
                    sw = float(V_np[pos] @ V_np[wpos])
                    if sw > s_d or (sw == s_d and slot < j):
                        s_d, j = sw, slot

                if s_d >= tau_di:
                    self._last_used_np[j] = ti
                    touched.add(j)
                    if j in written:  # answer arrives with the batch call
                        origin, by = False, "dynamic"
                        results[i] = ServeResult(None, "dynamic", False,
                                                 s_d, 0.0)
                        deferred.append((i, written[j][0]))
                    else:
                        origin = bool(self._static_origin_np[j])
                        by = "rewritten" if self._rewritten_np[j] \
                            else "dynamic"
                        results[i] = ServeResult(self.dyn_answers[j], by,
                                                 origin, s_d, 0.0)
                    content_of[i] = int(self._written_at_np[j])
                    self._mark_stale(results[i], vol[i], content_of[i], ti)
                    self.events.append((by, origin))
                else:
                    slot = self._host_lru_slot()
                    if slot not in saved:
                        saved[slot] = (bool(self._valid_np[slot]),
                                       int(self._last_used_np[slot]),
                                       bool(self._static_origin_np[slot]),
                                       int(self._written_at_np[slot]),
                                       int(self._expires_np[slot]),
                                       bool(self._rewritten_np[slot]),
                                       self.dyn_answers[slot])
                    exp = self._entry_expiry(prompts[i], ti)
                    self._mirror_write(slot, ti, static_origin=False,
                                       expires=exp)
                    self.dyn_answers[slot] = None
                    written[slot] = (i, pos)
                    excl.add(slot)
                    dead.discard(slot)
                    w_meta[slot] = (pos, ti,
                                    (metas[i] or {}).get("cls", -1), exp)
                    backend_rows.append(i)
                    backend_slots.append(slot)
                    results[i] = ServeResult(None, "backend", False, s_d,
                                             0.0)
                    content_of[i] = ti
                    self.events.append(("backend", False))
                self._adapt_record(V_np[pos], metas[i], h_i, seg_i,
                                   results[i], locked=True)
                grey_rows.append((prompts[i], V_np[pos], h_i, ss_i,
                                  results[i], metas[i], ti, tau_si))

            # backend first: a failed batch must not commit its inserts
            answers: List[object] = []
            if backend_rows:
                try:
                    # one batched backend call amortizes prefill
                    answers = self._backend_batch(
                        [prompts[i] for i in backend_rows])
                except Exception:
                    for slot, st in saved.items():
                        (self._valid_np[slot], self._last_used_np[slot],
                         self._static_origin_np[slot],
                         self._written_at_np[slot],
                         self._expires_np[slot],
                         self._rewritten_np[slot],
                         self.dyn_answers[slot]) = st
                    del self.events[ev0:]
                    self._apply_batch_writes(V, {}, touched, dead=dead)
                    raise
            self._apply_batch_writes(V, w_meta, touched, dead=dead)
            for slot, i, ans in zip(backend_slots, backend_rows, answers):
                # -1 = degenerate/bypass row, never cached; a slot whose
                # entry TTL-expired mid-batch (or was rewritten by a
                # later row) must not get this answer either
                if slot >= 0 and self._valid_np[slot] \
                        and written.get(slot, (None,))[0] == i:
                    self.dyn_answers[slot] = ans
                results[i].answer = ans
            for i, producer in deferred + l1_dup_fill:
                results[i].answer = results[producer].answer

        # L1 write-back: every semantic row's outcome becomes an exact-
        # match entry, in row order, after the batch's answers landed
        if self.l1 is not None:
            for i in sem:
                self.l1.put(keys[i], results[i].answer,
                            static_origin=results[i].static_origin,
                            content_t=content_of[i], expires_at=exp_of[i],
                            now=self.t - B + i + 1)

        lat = time.monotonic() - t0
        for r in results:
            r.latency_s = lat
        self._after_static_miss_batch(grey_rows)
        self._maybe_adapt()
        return results  # type: ignore[return-value]

    def _apply_batch_writes(self, V: torch.Tensor, w_meta: dict,
                            touched: set, dead=()) -> None:
        """Push a batch's accumulated inserts + LRU touches to the tier,
        one indexed write per field. ``dead`` slots (TTL-expired
        mid-batch, mirror-invalid) get their valid bit cleared first;
        inserts into slots the mirrors since invalidated are dropped."""
        dyn = self.dyn
        dead = sorted(s for s in dead if not self._valid_np[s])
        if dead:
            self._invalidate(dead)
        w_meta = {s: m for s, m in w_meta.items() if self._valid_np[s]}
        if w_meta:
            slots = list(w_meta)
            rows = [w_meta[s][0] for s in slots]
            self._bulk_insert_fn(dyn, V, slots, rows,
                                 [w_meta[s][1] for s in slots],
                                 [w_meta[s][2] for s in slots],
                                 exps=[w_meta[s][3] for s in slots])
            if self.dyn_index is not None:
                V_np = V.cpu().numpy()
                for s, r in zip(slots, rows):
                    self.dyn_index.record_write(int(s), V_np[r])
        upd = set(w_meta) | touched
        if upd:
            sl = np.fromiter(upd, np.int64, len(upd))
            self._touch_many(dyn, sl, self._last_used_np[sl])

    def describe_index(self) -> str:
        """Telemetry string for the static-tier lookup (router stats)."""
        if self.fused is not None:
            return self.fused.describe()
        if self.index is None:
            S = len(self._static_ref_np)
            if self.mesh is not None:
                return (f"sharded-flat(S={S}, "
                        f"shards={len(self.mesh.devices)})")
            return f"flat-exact(S={S})"
        describe = getattr(self.index, "describe", None)
        return describe() if describe else type(self.index).__name__

    def describe_dyn_index(self) -> str:
        """Telemetry string for the dynamic-tier lookup path."""
        if self.dyn_index is None:
            if self.mesh is not None:
                return (f"sharded-masked(C={self.cfg.capacity}, "
                        f"shards={len(self.mesh.devices)})")
            return f"flat-masked(C={self.cfg.capacity})"
        describe = getattr(self.dyn_index, "describe", None)
        return describe() if describe else type(self.dyn_index).__name__

    def shard_stats(self) -> Optional[dict]:
        """Mesh-serving telemetry: the shard count and the per-shard
        occupancy of the row-sharded dynamic tier, from the host mirrors
        (no device round-trip). None when serving on one device."""
        if self.mesh is None:
            return None
        n_shards = len(self.mesh.devices)
        occ = self._valid_np.reshape(n_shards, -1).sum(axis=1)
        return {"shards": n_shards,
                "shard_occupancy": [int(x) for x in occ]}

    def dyn_index_stats(self) -> Optional[dict]:
        """Segment/tail occupancy and compaction counters of the
        injected dynamic index (None on the flat path), for the router."""
        if self.dyn_index is None:
            return None
        stats = getattr(self.dyn_index, "stats", None)
        return stats() if stats else None

    def stats(self) -> dict:
        n = max(len(self.events), 1)
        by = [e[0] for e in self.events]
        # the L1 tier's own counters first: the policy-level keys (l1_hits
        # also counts in-batch repeats the tier never probes) win
        out = dict(self.l1.stats()) if self.l1 is not None else {}
        out.update({
            "requests": len(self.events),
            "static_hit_rate": by.count("static") / n,
            "dynamic_hit_rate": by.count("dynamic") / n,
            "rewritten_hit_rate": by.count("rewritten") / n,
            "backend_rate": by.count("backend") / n,
            "l1_hit_rate": by.count("l1") / n,
            "static_origin_rate": sum(1 for e in self.events if e[1]) / n,
            "l1_hits": self._l1_hits,
            "l1_bypass_volatile": self._l1_bypass,
            "stale_serves": self._stale_serves,
            "ttl_evictions": self._ttl_evictions,
        })
        if self.adaptive is not None:
            out.update(self.adaptive.stats())
        return out

    def feedback(self, seq: int, ok: bool) -> bool:
        """Operator error feedback on a served answer (``seq`` is the
        ``adapt_seq`` in the ServeResult meta): a wrong-answer report
        poisons the window row's label. False without a controller or
        when the row has rotated out of the window."""
        if self.adaptive is None:
            return False
        with self.dyn_lock:
            before = self.adaptive.feedbacks
            self.adaptive.record_feedback(seq, ok)
            return self.adaptive.feedbacks > before


class KritesPolicy(BaselinePolicy):
    """Algorithm 2: baseline serving + async grey-zone verification."""

    def __init__(self, cfg: T.CacheConfig, static_tier: T.StaticTier,
                 static_answers, embed_fn, backend_fn, judge_fn, d: int,
                 n_workers: int = 2,
                 judge_rate_per_s: Optional[float] = None, *,
                 embed_batch_fn: Optional[Callable] = None,
                 backend_batch_fn: Optional[Callable] = None,
                 index=None, dyn_index=None, static_texts=None,
                 mesh=None, shard_axis: str = "model", wal=None,
                 fused=None, l1=None, freshness=None, adaptive=None,
                 rewriter=None, device=None):
        super().__init__(cfg, static_tier, static_answers, embed_fn,
                         backend_fn, d, embed_batch_fn=embed_batch_fn,
                         backend_batch_fn=backend_batch_fn, index=index,
                         dyn_index=dyn_index, static_texts=static_texts,
                         mesh=mesh, shard_axis=shard_axis, fused=fused, l1=l1,
                         freshness=freshness, adaptive=adaptive,
                         device=device)
        # write-ahead promotion journal (core/promo_wal.py): each applied
        # promotion is appended inside dyn_lock, before its upsert, and
        # replayed idempotently on restart through the same LWW contract
        self.wal = wal
        # one judge-budget knob: cfg.judge_rate (per request) is the
        # default; judge_rate_per_s is a wall-clock override
        if judge_rate_per_s is None:
            rate_kw = dict(rate_per_s=0.0, rate_per_req=cfg.judge_rate)
        else:
            rate_kw = dict(rate_per_s=judge_rate_per_s)
        self._judge_fn = judge_fn
        # rewriter for REWRITE verdicts, run on the pool's worker threads;
        # budgeted by cfg.rewrite_rate tokens per judged task (an empty
        # bucket downgrades the verdict to REJECT)
        self._rewriter = rewriter
        self._rw_rate = float(cfg.rewrite_rate)
        self._rw_budget = 0.0
        self._rw_lock = threading.Lock()
        self.pool = VerifyAndPromotePool(
            judge_fn=self._judge_payload,
            promote_fn=self._promote,
            n_workers=n_workers, **rate_kw)

    def _judge_payload(self, payload: dict) -> Verdict:
        """Pool adapter: run the judge over the payload's verification
        triple and, for promoting outcomes, stamp the TTL verdict onto
        the payload, which rides into ``_promote`` (and the WAL). A
        REWRITE verdict runs the rewriter here, on the worker thread.
        The verdict also rewrites the adaptive window row's label."""
        ja = payload["judge_args"]
        # the rewrite bucket refills per judged task, rewrite or not
        if self._rewriter is not None:
            with self._rw_lock:
                self._rw_budget = min(self._rw_budget + self._rw_rate, 1e9)
        verdict = as_verdict(self._judge_fn(**ja))
        if verdict.outcome == REWRITE:
            verdict = self._try_rewrite(verdict, payload, ja)
        if verdict.outcome != REJECT:
            payload["ttl"] = int(verdict.ttl) if verdict.ttl is not None \
                else self._assign_ttl(ja)
        payload["outcome"] = verdict.outcome
        # REWRITE counts as not approved: the static neighbor as-is
        # would have been an error
        seq = payload.get("adapt_seq", 0)
        if self.adaptive is not None and seq:
            with self.dyn_lock:
                self.adaptive.record_verdict(seq, verdict.approved,
                                             ja["h_cls"])
        return verdict

    def _try_rewrite(self, verdict: Verdict, payload: dict,
                     ja: dict) -> Verdict:
        """Resolve a REWRITE verdict into a promotable tailored answer,
        or degrade it to REJECT: no rewriter / rewriter raised / empty
        text -> ``rewrite_failed``; empty token bucket ->
        ``rewrite_rate_limited`` (flags ride the payload for the pool's
        stats)."""
        if self._rewriter is None:
            payload["rewrite_failed"] = True
            return Verdict(REJECT, confidence=verdict.confidence)
        with self._rw_lock:
            if self._rw_budget < 1.0:
                payload["rewrite_rate_limited"] = True
                return Verdict(REJECT, confidence=verdict.confidence)
            self._rw_budget -= 1.0
        text = verdict.text
        if not text:
            try:
                text = self._rewriter(ja.get("q_text", ""),
                                      ja.get("h_text", ""),
                                      ja.get("answer", ""))
            except Exception:  # noqa: BLE001 — degrade, don't retry:
                text = ""      # a broken rewriter must stay deterministic
        if not text:
            payload["rewrite_failed"] = True
            return Verdict(REJECT, confidence=verdict.confidence)
        payload["rewritten"] = str(text)
        return Verdict(REWRITE, text=str(text), ttl=verdict.ttl,
                       confidence=verdict.confidence)

    def _assign_ttl(self, ja: dict) -> int:
        """TTL verdict precedence: a freshness-aware judge is
        authoritative (it saw the texts); else the policy's own
        classifier; else the config-wide ttl (0 = unbounded)."""
        judge = self._judge_fn
        if getattr(judge, "freshness", None) is not None:
            return int(judge.assign_ttl(ja.get("q_text", ""),
                                        ja.get("h_text", ""),
                                        ja.get("answer", "")))
        if self.freshness is not None:
            return int(self.freshness.ttl_for_text(
                ja.get("q_text", "") or ja.get("h_text", "")))
        return int(self.cfg.ttl)

    def _grey_submission(self, prompt, v, h_idx, s_static, res, meta,
                         enq_t, tau_s=None):
        """Alg. 2 grey-zone gate -> (key, payload) for the pool, or None.
        ``tau_s`` is the live tau_static the serving decision used. The
        payload's ``judge_args`` carry the verification triple: the
        query text, the static neighbor's prompt text (``static_texts``,
        else the curated answer as a proxy) and the curated answer."""
        if tau_s is None:
            tau_s = self.cfg.tau_static
        if not (self.cfg.sigma_min <= s_static < tau_s):
            return None
        if self.cfg.dedup and res.served_by in ("dynamic", "rewritten") \
                and res.static_origin:
            return None  # a promoted pointer already serves this query
        va = np.asarray(v)
        fp = hash(va.tobytes())
        answer = self._serve_static(h_idx)
        h_text = self.static_texts[h_idx] \
            if self.static_texts is not None else str(answer)
        return ((fp, h_idx), {
            "v": va,
            "h_idx": h_idx,
            "enq_t": enq_t,
            "adapt_seq": res.meta.get("adapt_seq", 0),
            "judge_args": {
                "q_cls": (meta or {}).get("cls", -1),
                "h_cls": int(self._static_cls_np[h_idx]),
                "q_text": prompt or "",
                "h_text": h_text,
                "answer": "" if answer is None else str(answer),
            },
        })

    def _after_static_miss(self, prompt, v, h_idx, s_static, res, meta,
                           tau_s=None):
        sub = self._grey_submission(prompt, v, h_idx, s_static, res, meta,
                                    self.t, tau_s)
        if sub is not None:
            self.pool.submit(*sub)

    def _after_static_miss_batch(self, rows) -> None:
        items = []
        for prompt, v, h_idx, s_static, res, meta, enq_t, tau_s in rows:
            sub = self._grey_submission(prompt, v, h_idx, s_static, res,
                                        meta, enq_t, tau_s)
            if sub is not None:
                items.append(sub)
        if items:
            self.pool.submit_many(items)

    def _promote(self, payload: dict, journal: bool = True):
        """Auxiliary overwrite: upsert the curated static answer (or, for
        a REWRITE, the tailored text keyed to the query's class, with the
        ``answer_ref == -2`` sentinel) under the new key. Near-duplicate
        keys overwrite in place, and an entry written after this task was
        enqueued (``written_at > enq_t``) wins over the stale promotion
        (LWW), which then touches nothing and is not journaled.

        With a ``wal`` an applied promotion is journaled before its
        upsert; ``journal=False`` is the replay path. ``written_at`` gets
        ``enq_t``; ``last_used`` gets the live clock, so a promotion
        applied after a slow judge lands LRU-warm. Expiry anchors at
        ``enq_t``, which the WAL record carries."""
        h_idx = payload["h_idx"]
        v = torch.as_tensor(payload["v"]).to(self.device)
        enq_t = payload["enq_t"]
        ja = payload.get("judge_args", {})
        ttl = int(payload.get("ttl", self.cfg.ttl))
        exp = enq_t + ttl if ttl > 0 else 0
        outcome = payload.get("outcome", APPROVE)
        if outcome == REJECT:
            return
        rewrite = outcome == REWRITE
        if rewrite:
            answer = payload.get("rewritten", "")
            if not answer:
                return   # defensive: a REWRITE without text is a no-op
            cls, ref = int(ja.get("q_cls", -1)), -2
        else:
            answer = self._serve_static(h_idx)
            cls = int(self._static_cls_np[h_idx])
            ref = int(self._static_ref_np[h_idx])
        with self.dyn_lock:
            apply_t = self.t      # live LRU clock, read under the lock
            self._sweep_expired_locked(apply_t)
            if exp and exp < apply_t:
                return  # verdict outlived its own TTL; nothing to apply
            # the dedup lookup rides the same dynamic index as serving,
            # or the row-sharded masked scan under a mesh
            if self.mesh is not None:
                sd, jd = self._dyn_topk(self.dyn, v[None])
                s_d, j = float(sd[0]), int(jd[0])
            else:
                s_d, j = T.dynamic_lookup(self.dyn, v, index=self.dyn_index)
                s_d, j = float(s_d), int(j)
            dup = s_d >= self.cfg.dup_threshold
            if dup and self._written_at_np[j] > enq_t:
                return       # LWW: a newer write owns this key
            if journal and self.wal is not None:
                self.wal.append(encode_record(
                    payload["v"], h_idx, enq_t, ttl=ttl,
                    q_text=ja.get("q_text", ""),
                    h_text=ja.get("h_text", ""),
                    outcome=REWRITE if rewrite else APPROVE,
                    rewritten=str(answer) if rewrite else "",
                    q_cls=int(ja.get("q_cls", -1))))
            slot = j if dup else self._host_lru_slot()
            self._write_fn(self.dyn, slot, v, cls, ref, True, enq_t,
                           last_used=apply_t, expires=exp)
            self._mirror_write(slot, apply_t, static_origin=True,
                               written_at=enq_t, expires=exp,
                               rewritten=rewrite)
            if self.dyn_index is not None:
                self.dyn_index.record_write(slot, payload["v"])
            self.dyn_answers[slot] = answer

    def stats(self) -> dict:
        out = super().stats()
        ps = self.pool.stats
        out.update({"judge_submitted": ps.submitted,
                    "judge_deduped": ps.deduped,
                    "judge_rate_limited": ps.rate_limited,
                    "judged": ps.judged, "approved": ps.approved,
                    "rejected": ps.rejected,
                    "rewritten": ps.rewritten,
                    "rewrite_failed": ps.rewrite_failed,
                    "rewrite_rate_limited": ps.rewrite_rate_limited,
                    "redispatched": ps.redispatched})
        if self.wal is not None:
            ws = self.wal.stats()
            out["wal_seq"] = ws["seq"]
            out["wal_synced_seq"] = ws["synced_seq"]
        return out
