"""Live (host-level) tiered semantic cache policies, flat configuration.

Port of ``repro/core/policy.py``:

``BaselinePolicy`` = Algorithm 1 (static thresholds over a static and a
                     dynamic tier);
``KritesPolicy``   = Algorithm 2: the same serving path plus the
                     grey-zone trigger feeding the async VerifyAndPromote
                     pool.

Two serving entry points share one decision procedure: ``serve(prompt)``
(scalar) and ``serve_batch(prompts)``, the batched hot path, which embeds
the micro-batch at once, does ONE fused static-tier top-1 through
``kernels/simsearch`` (the CUDA kernel on the card) and ONE masked
dynamic-tier top-1, then resolves rows in request order so results equal
calling ``serve`` per row. Misses go to the backend as one batch and the
batch's tier writes land as one scatter at the end.

The policy keeps host mirrors of the dynamic tier's decision metadata
(valid / last_used / static_origin / written_at / expires_at) so per-row
bookkeeping never costs a device round-trip; every mutation path updates
both under ``dyn_lock``. The dynamic tier is updated IN PLACE
(``core/tiers.py``), where the JAX policy swaps in a new pytree.

Only the flat configuration is ported so far: the ANN indexes, the
fused lookup, meshes, the L1 front, the freshness layer, adaptive
thresholds, the promotion WAL and the rewriter raise
``NotImplementedError`` naming the ROADMAP item that brings them.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import tiers as T
from repro_torch.core.async_queue import VerifyAndPromotePool
from repro_torch.core.judge import APPROVE, REJECT, REWRITE, Verdict, \
    as_verdict
from repro_torch.device import get_device
from repro_torch.index.flat import l2_normalize, masked_cosine_topk

_BIG = np.int64(2**30)   # host twin of tiers.BIG (LRU key for invalid rows)

# options of the JAX policy that the port does not take yet, with the
# ROADMAP item (queue 1) that brings each
_NOT_PORTED = {
    "index": "static ANN",
    "dyn_index": "dynamic ANN",
    "fused": "fused lookup",
    "mesh": "multi-GPU",
    "l1": "operability",
    "freshness": "operability",
    "adaptive": "operability",
    "wal": "operability",
    "rewriter": "operability",
}


def _reject_unported(**opts) -> None:
    for name, value in opts.items():
        if value is not None:
            raise NotImplementedError(
                f"{name}= is not ported yet: see ROADMAP.md, queue 1, "
                f"'{_NOT_PORTED[name]}'")


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
    served_by: str   # 'static' | 'dynamic' | 'backend'
    static_origin: bool
    similarity: float
    latency_s: float
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
                 mesh=None, fused=None, l1=None, freshness=None,
                 adaptive=None, device=None):
        _reject_unported(index=index, dyn_index=dyn_index, mesh=mesh,
                         fused=fused, l1=l1, freshness=freshness,
                         adaptive=adaptive)
        self.device = get_device(device)
        if static_tier.emb.device != self.device:
            raise ValueError(f"static tier on {static_tier.emb.device}, "
                             f"policy on {self.device}")
        self.cfg = cfg
        self.static = static_tier
        self.static_answers = static_answers
        # prompt texts of the curated entries, row-aligned: the judge
        # verifies on the (q_text, h_text, answer) triple
        self.static_texts = list(static_texts) if static_texts is not None \
            else None
        self.embed_fn = embed_fn
        self.backend_fn = backend_fn
        self.embed_batch_fn = embed_batch_fn
        self.backend_batch_fn = backend_batch_fn
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

    def _serve_static(self, idx: int):
        return self.static_answers[int(self._static_ref_np[idx])]

    def _static_topk_batch(self, V: torch.Tensor):
        """Static-tier top-1 for a (B, d) block: the fused simsearch
        kernel on the card, its plain version on the CPU."""
        return T.static_lookup_batch(self.static, V)

    def _dyn_topk(self, dyn: T.DynamicTier, q: torch.Tensor):
        return _masked_dyn_topk(dyn.emb, dyn.valid, q)

    def _host_lru_slot(self) -> int:
        """Host twin of tiers._lru_slot over the mirrored metadata."""
        key = np.where(self._valid_np, self._last_used_np, -_BIG)
        return int(key.argmin())

    # -- hooks for Krites (no-ops in the baseline) -------------------------
    def _after_static_miss(self, prompt, v, h_idx, s_static, res, meta):
        return

    def _after_static_miss_batch(self, rows) -> None:
        return

    def _embed_one(self, prompt: str) -> torch.Tensor:
        return l2_normalize(torch.as_tensor(
            np.asarray(self.embed_fn(prompt), np.float32)).to(self.device))

    def serve(self, prompt: str, meta: Optional[dict] = None) -> ServeResult:
        """Scalar serving entry (Algorithm 1, plus Algorithm 2's grey-zone
        trigger in the Krites subclass)."""
        t0 = time.monotonic()
        self.t += 1
        v = self._embed_one(prompt)
        v_np = v.cpu().numpy()
        if not _usable_rows(v_np[None])[0]:
            # degenerate embedding: backend without caching and without
            # a grey trigger (a promotion would insert the same key)
            res = ServeResult(self.backend_fn(prompt), "backend", False,
                              0.0, time.monotonic() - t0)
            self.events.append((res.served_by, res.static_origin))
            return res
        tau_s, tau_d = self.cfg.tau_static, self.cfg.tau_dynamic
        s_s, h_idx = T.static_lookup(self.static, v)
        s_s, h_idx = float(s_s), int(h_idx)
        if s_s >= tau_s:
            res = ServeResult(self._serve_static(h_idx), "static", True,
                              s_s, time.monotonic() - t0)
            self.events.append((res.served_by, res.static_origin))
            return res

        with self.dyn_lock:
            self._sweep_expired_locked(self.t)
            sd, jd = self._dyn_topk(self.dyn, v[None])
            s_d, j = float(sd[0]), int(jd[0])
            res = None
            if s_d >= tau_d:
                T.touch(self.dyn, j, self.t)
                self._last_used_np[j] = self.t
                res = ServeResult(self.dyn_answers[j], "dynamic",
                                  bool(self._static_origin_np[j]), s_d,
                                  time.monotonic() - t0)

        if res is None:
            answer = self.backend_fn(prompt)   # outside the lock
            exp = self._entry_expiry(self.t)
            with self.dyn_lock:
                slot = self._host_lru_slot()
                T._write(self.dyn, slot, v, (meta or {}).get("cls", -1),
                         -1, False, self.t, expires=exp)
                self._mirror_write(slot, self.t, static_origin=False,
                                   expires=exp)
                self.dyn_answers[slot] = answer
            res = ServeResult(answer, "backend", False, s_d,
                              time.monotonic() - t0)

        self.events.append((res.served_by, res.static_origin))
        # Alg. 2 line 13: grey-zone test on EVERY static miss
        self._after_static_miss(prompt, v_np, h_idx, s_s, res, meta)
        return res

    def _mirror_write(self, slot: int, now: int, static_origin: bool,
                      written_at: Optional[int] = None,
                      expires: int = 0):
        """Host twin of a tier row write. ``now`` is the LRU clock;
        ``written_at`` (the LWW clock) defaults to it, async promotions
        pass their enqueue time."""
        self._valid_np[slot] = True
        self._last_used_np[slot] = now
        self._static_origin_np[slot] = static_origin
        self._written_at_np[slot] = now if written_at is None \
            else written_at
        self._expires_np[slot] = expires
        if expires > 0:
            self._ttl_active = True

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
        idx = torch.as_tensor(dead, dtype=torch.int64, device=self.device)
        self.dyn.valid[idx] = False
        self.dyn.expires_at[idx] = 0
        for s in dead:
            self.dyn_answers[int(s)] = None
        self._ttl_evictions += len(dead)
        return len(dead)

    def _entry_expiry(self, now: int) -> int:
        """Per-entry expiry stamp for a cache write at tick ``now``: the
        global ``cfg.ttl`` (0 = never)."""
        return now + self.cfg.ttl if self.cfg.ttl > 0 else 0

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
        ok = snap.valid & torch.as_tensor(~excl, device=self.device)
        sims = torch.where(ok, snap.emb @ v,
                           torch.tensor(float("-inf"), device=self.device))
        j = int(torch.argmax(sims))
        return float(sims[j]), j

    def serve_batch(self, prompts: Sequence[str],
                    metas: Optional[Sequence[Optional[dict]]] = None
                    ) -> List[ServeResult]:
        """Serve a micro-batch. Equivalent, request for request, to
        calling :meth:`serve` on each prompt in order (same answers,
        served_by, static_origin and promotions).

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

        V = self._embed_batch(prompts)                         # (B, d)
        # degenerate-embedding guard: zero out unusable rows so one NaN
        # can't leak through the lookups; they are served backend-only
        ok = _usable_rows(V.cpu().numpy())
        if not ok.all():
            V = torch.where(torch.as_tensor(ok, device=self.device)[:, None],
                            V, torch.zeros((), device=self.device))
        V_np = V.cpu().numpy()
        s_sb, h_idxb = self._static_topk_batch(V)              # fused top-1
        s_sb, h_idxb = s_sb.cpu().numpy(), h_idxb.cpu().numpy()

        results: List[Optional[ServeResult]] = [None] * B
        grey_rows = []          # static-miss rows, for the Krites hook
        ev0 = len(self.events)  # rollback point: a failed batch serves
        with self.dyn_lock:     # nobody, so it must record no events
            snap = self.dyn     # unchanged until _apply_batch_writes
            s_db, j_db = self._dyn_topk(snap, V)
            s_db, j_db = s_db.cpu().numpy(), j_db.cpu().numpy()

            written: dict = {}   # slot -> row of its last writer
            w_meta: dict = {}    # slot -> (row, t, cls, exp) bulk write
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
                if not ok[i]:
                    # backend-only: slot sentinel -1 skips the cache write
                    backend_rows.append(i)
                    backend_slots.append(-1)
                    results[i] = ServeResult(None, "backend", False,
                                             0.0, 0.0)
                    self.events.append(("backend", False))
                    continue
                ss_i, h_i = float(s_sb[i]), int(h_idxb[i])
                if ss_i >= self.cfg.tau_static:
                    results[i] = ServeResult(self._serve_static(h_i),
                                             "static", True, ss_i, 0.0)
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
                        self.dyn_answers[s] = None
                        written.pop(s, None)
                        dead.add(s)
                        excl.add(s)
                    self._ttl_evictions += len(newly)

                # dynamic candidate = snapshot best, repaired for slots
                # overwritten/expired this batch, merged with intra-batch
                # inserts
                s_d, j = float(s_db[i]), int(j_db[i])
                if j in excl:
                    s_d, j = self._snap_best_excluding(snap, V[i], excl)
                for slot, wrow in written.items():
                    sw = float(V_np[i] @ V_np[wrow])
                    if sw > s_d or (sw == s_d and slot < j):
                        s_d, j = sw, slot

                if s_d >= self.cfg.tau_dynamic:
                    self._last_used_np[j] = ti
                    touched.add(j)
                    if j in written:  # answer arrives with the batch call
                        origin = False
                        results[i] = ServeResult(None, "dynamic", False,
                                                 s_d, 0.0)
                        deferred.append((i, written[j]))
                    else:
                        origin = bool(self._static_origin_np[j])
                        results[i] = ServeResult(self.dyn_answers[j],
                                                 "dynamic", origin, s_d,
                                                 0.0)
                    self.events.append(("dynamic", origin))
                else:
                    slot = self._host_lru_slot()
                    if slot not in saved:
                        saved[slot] = (bool(self._valid_np[slot]),
                                       int(self._last_used_np[slot]),
                                       bool(self._static_origin_np[slot]),
                                       int(self._written_at_np[slot]),
                                       int(self._expires_np[slot]),
                                       self.dyn_answers[slot])
                    exp = self._entry_expiry(ti)
                    self._mirror_write(slot, ti, static_origin=False,
                                       expires=exp)
                    self.dyn_answers[slot] = None
                    written[slot] = i
                    excl.add(slot)
                    dead.discard(slot)
                    w_meta[slot] = (i, ti, (metas[i] or {}).get("cls", -1),
                                    exp)
                    backend_rows.append(i)
                    backend_slots.append(slot)
                    results[i] = ServeResult(None, "backend", False, s_d,
                                             0.0)
                    self.events.append(("backend", False))
                grey_rows.append((prompts[i], V_np[i], h_i, ss_i,
                                  results[i], metas[i], ti))

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
                         self.dyn_answers[slot]) = st
                    del self.events[ev0:]
                    self._apply_batch_writes(V, {}, touched, dead=dead)
                    raise
            self._apply_batch_writes(V, w_meta, touched, dead=dead)
            for slot, i, ans in zip(backend_slots, backend_rows, answers):
                # -1 = degenerate row, never cached; a slot whose entry
                # TTL-expired mid-batch (or was rewritten by a later row)
                # must not get this answer either
                if slot >= 0 and self._valid_np[slot] \
                        and written.get(slot) == i:
                    self.dyn_answers[slot] = ans
                results[i].answer = ans
            for i, producer in deferred:
                results[i].answer = results[producer].answer

        lat = time.monotonic() - t0
        for r in results:
            r.latency_s = lat
        self._after_static_miss_batch(grey_rows)
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
            idx = torch.as_tensor(dead, dtype=torch.int64,
                                  device=self.device)
            dyn.valid[idx] = False
            dyn.expires_at[idx] = 0
        w_meta = {s: m for s, m in w_meta.items() if self._valid_np[s]}
        if w_meta:
            slots = list(w_meta)
            _bulk_insert(dyn, V, slots, [w_meta[s][0] for s in slots],
                         [w_meta[s][1] for s in slots],
                         [w_meta[s][2] for s in slots],
                         [w_meta[s][3] for s in slots])
        upd = set(w_meta) | touched
        if upd:
            sl = np.fromiter(upd, np.int64, len(upd))
            T.touch_many(dyn, sl, self._last_used_np[sl])

    def describe_index(self) -> str:
        """Telemetry string for the static-tier lookup (router stats)."""
        return f"flat-exact(S={len(self._static_ref_np)})"

    def describe_dyn_index(self) -> str:
        return f"flat-masked(C={self.cfg.capacity})"

    def stats(self) -> dict:
        n = max(len(self.events), 1)
        by = [e[0] for e in self.events]
        return {
            "requests": len(self.events),
            "static_hit_rate": by.count("static") / n,
            "dynamic_hit_rate": by.count("dynamic") / n,
            "backend_rate": by.count("backend") / n,
            "static_origin_rate": sum(1 for e in self.events if e[1]) / n,
            "ttl_evictions": self._ttl_evictions,
        }


class KritesPolicy(BaselinePolicy):
    """Algorithm 2: baseline serving + async grey-zone verification."""

    def __init__(self, cfg: T.CacheConfig, static_tier: T.StaticTier,
                 static_answers, embed_fn, backend_fn, judge_fn, d: int,
                 n_workers: int = 2,
                 judge_rate_per_s: Optional[float] = None, *,
                 embed_batch_fn: Optional[Callable] = None,
                 backend_batch_fn: Optional[Callable] = None,
                 index=None, dyn_index=None, static_texts=None,
                 mesh=None, wal=None, fused=None, l1=None, freshness=None,
                 adaptive=None, rewriter=None, device=None):
        _reject_unported(wal=wal, rewriter=rewriter)
        super().__init__(cfg, static_tier, static_answers, embed_fn,
                         backend_fn, d, embed_batch_fn=embed_batch_fn,
                         backend_batch_fn=backend_batch_fn, index=index,
                         dyn_index=dyn_index, static_texts=static_texts,
                         mesh=mesh, fused=fused, l1=l1,
                         freshness=freshness, adaptive=adaptive,
                         device=device)
        # one judge-budget knob: cfg.judge_rate (per request) is the
        # default; judge_rate_per_s is a wall-clock override
        if judge_rate_per_s is None:
            rate_kw = dict(rate_per_s=0.0, rate_per_req=cfg.judge_rate)
        else:
            rate_kw = dict(rate_per_s=judge_rate_per_s)
        self._judge_fn = judge_fn
        self.pool = VerifyAndPromotePool(
            judge_fn=self._judge_payload,
            promote_fn=self._promote,
            n_workers=n_workers, **rate_kw)

    def _judge_payload(self, payload: dict) -> Verdict:
        """Pool adapter: run the judge over the payload's verification
        triple and, for an approval, stamp its TTL verdict onto the
        payload, which rides into ``_promote``. With no rewriter ported
        yet, a REWRITE verdict degrades to REJECT (``rewrite_failed``),
        as the JAX policy does without one."""
        ja = payload["judge_args"]
        verdict = as_verdict(self._judge_fn(**ja))
        if verdict.outcome == REWRITE:
            payload["rewrite_failed"] = True
            verdict = Verdict(REJECT, confidence=verdict.confidence)
        if verdict.outcome != REJECT:
            payload["ttl"] = int(verdict.ttl) if verdict.ttl is not None \
                else self._assign_ttl(ja)
        payload["outcome"] = verdict.outcome
        return verdict

    def _assign_ttl(self, ja: dict) -> int:
        """TTL verdict precedence: a freshness-aware judge is
        authoritative (it saw the texts); else the config-wide ttl
        (0 = unbounded)."""
        judge = self._judge_fn
        if getattr(judge, "freshness", None) is not None:
            return int(judge.assign_ttl(ja.get("q_text", ""),
                                        ja.get("h_text", ""),
                                        ja.get("answer", "")))
        return int(self.cfg.ttl)

    def _grey_submission(self, prompt, v, h_idx, s_static, res, meta,
                         enq_t):
        """Alg. 2 grey-zone gate -> (key, payload) for the pool, or None.
        The payload's ``judge_args`` carry the verification triple: the
        query text, the static neighbor's prompt text (``static_texts``,
        else the curated answer as a proxy) and the curated answer."""
        if not (self.cfg.sigma_min <= s_static < self.cfg.tau_static):
            return None
        if self.cfg.dedup and res.served_by == "dynamic" \
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
            "judge_args": {
                "q_cls": (meta or {}).get("cls", -1),
                "h_cls": int(self._static_cls_np[h_idx]),
                "q_text": prompt or "",
                "h_text": h_text,
                "answer": "" if answer is None else str(answer),
            },
        })

    def _after_static_miss(self, prompt, v, h_idx, s_static, res, meta):
        sub = self._grey_submission(prompt, v, h_idx, s_static, res, meta,
                                    self.t)
        if sub is not None:
            self.pool.submit(*sub)

    def _after_static_miss_batch(self, rows) -> None:
        items = []
        for prompt, v, h_idx, s_static, res, meta, enq_t in rows:
            sub = self._grey_submission(prompt, v, h_idx, s_static, res,
                                        meta, enq_t)
            if sub is not None:
                items.append(sub)
        if items:
            self.pool.submit_many(items)

    def _promote(self, payload: dict):
        """Auxiliary overwrite: upsert the curated static answer under
        the new key. Near-duplicate keys overwrite in place, and an entry
        written after this task was enqueued (``written_at > enq_t``)
        wins over the stale promotion (LWW), which then touches nothing.
        ``written_at`` gets ``enq_t``; ``last_used`` gets the live clock,
        so a promotion applied after a slow judge lands LRU-warm."""
        h_idx = payload["h_idx"]
        v = torch.as_tensor(payload["v"]).to(self.device)
        enq_t = payload["enq_t"]
        ttl = int(payload.get("ttl", self.cfg.ttl))
        exp = enq_t + ttl if ttl > 0 else 0
        if payload.get("outcome", APPROVE) != APPROVE:
            return
        answer = self._serve_static(h_idx)
        cls = int(self._static_cls_np[h_idx])
        ref = int(self._static_ref_np[h_idx])
        with self.dyn_lock:
            apply_t = self.t      # live LRU clock, read under the lock
            self._sweep_expired_locked(apply_t)
            if exp and exp < apply_t:
                return  # verdict outlived its own TTL; nothing to apply
            s_d, j = T.dynamic_lookup(self.dyn, v)
            s_d, j = float(s_d), int(j)
            dup = s_d >= self.cfg.dup_threshold
            if dup and self._written_at_np[j] > enq_t:
                return       # LWW: a newer write owns this key
            slot = j if dup else self._host_lru_slot()
            T._write(self.dyn, slot, v, cls, ref, True, enq_t,
                     last_used=apply_t, expires=exp)
            self._mirror_write(slot, apply_t, static_origin=True,
                               written_at=enq_t, expires=exp)
            self.dyn_answers[slot] = answer

    def stats(self) -> dict:
        out = super().stats()
        ps = self.pool.stats
        out.update({"judge_submitted": ps.submitted,
                    "judge_deduped": ps.deduped,
                    "judge_rate_limited": ps.rate_limited,
                    "judged": ps.judged, "approved": ps.approved,
                    "rejected": ps.rejected,
                    "rewrite_failed": ps.rewrite_failed,
                    "redispatched": ps.redispatched})
        return out
