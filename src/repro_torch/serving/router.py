"""Micro-batching request router in front of a cache policy.

``CacheRouter`` is the serving front door (DESIGN.md §7): concurrent
callers ``submit()`` prompts; a collector thread coalesces them into
micro-batches (``max_batch`` requests or ``max_wait_ms``, whichever first)
and drives ``policy.serve_batch`` — so the embed, the fused static-tier
top-k, the masked dynamic lookup and the backend prefill are all amortized
across in-flight requests, while per-request semantics stay identical to
the scalar ``policy.serve`` path.

The router also owns the serving telemetry: per-tier hit counters, batch
occupancy, error counts, and end-to-end (enqueue -> answer) latency
percentiles.

The queue + collector machinery lives in ``_MicroBatcher`` and is shared
with :class:`repro_torch.serving.engine.BatchingFrontend`, which batches raw
engine requests the same way.
"""
from __future__ import annotations

import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence


@dataclass
class _PendingRequest:
    prompt: str
    meta: Optional[dict] = None
    enq_t: float = field(default_factory=time.monotonic)
    done: threading.Event = field(default_factory=threading.Event)
    result: object = None
    error: Optional[BaseException] = None
    latency_s: float = 0.0


class _MicroBatcher:
    """Queue + collector thread coalescing submissions into batches.

    ``serve_fn(batch)`` receives a list of :class:`_PendingRequest` and
    fills each ``result``; if it raises, every request in the batch gets
    the exception on ``error`` instead. Completion events are always set,
    so callers never hang on a failed batch.
    """

    def __init__(self, serve_fn: Callable[[List[_PendingRequest]], None],
                 max_batch: int, max_wait_s: float,
                 name: str = "micro-batcher"):
        self.serve_fn = serve_fn
        self.max_batch = max_batch
        self.max_wait = max_wait_s
        self.q: "queue.Queue[_PendingRequest]" = queue.Queue()
        self.failed_batches = 0     # batches whose serve_fn raised
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name=name)
        self._worker.start()

    def submit(self, prompt: str,
               meta: Optional[dict] = None) -> _PendingRequest:
        p = _PendingRequest(prompt, meta)
        self.q.put(p)
        return p

    def _run(self):
        while not self._stop.is_set():
            try:
                first = self.q.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            t0 = time.monotonic()
            while len(batch) < self.max_batch \
                    and time.monotonic() - t0 < self.max_wait:
                try:
                    batch.append(self.q.get_nowait())
                except queue.Empty:
                    time.sleep(0.0005)
            try:
                self.serve_fn(batch)
            except Exception as e:  # noqa: BLE001 — surface, don't strand
                self.failed_batches += 1
                for p in batch:
                    p.error = e
            finally:
                now = time.monotonic()
                for p in batch:
                    p.latency_s = now - p.enq_t
                    p.done.set()

    def stop(self):
        self._stop.set()
        self._worker.join(timeout=2.0)


class CacheRouter:
    """Request queue + micro-batcher over ``policy.serve_batch``."""

    def __init__(self, policy, max_batch: int = 32,
                 max_wait_ms: float = 2.0, latency_window: int = 100_000):
        self.policy = policy
        self._lock = threading.Lock()
        self._tier_counts = {"l1": 0, "static": 0, "dynamic": 0,
                             "rewritten": 0, "backend": 0}
        self._static_origin = 0
        self._promoted = 0          # dynamic hits serving promoted content
        self._stale = 0             # hits flagged stale by the drift clock
        self._bypassed = 0          # volatile requests routed cache-free
        self._requests = 0
        # latency percentiles come from a bounded window so a long-lived
        # router neither leaks memory nor sorts its whole history
        self._latencies: deque = deque(maxlen=latency_window)
        self._batches = 0
        self._batched_requests = 0
        self._errors = 0
        self._last_error = ""
        self._mb = _MicroBatcher(self._serve, max_batch,
                                 max_wait_ms / 1e3, name="cache-router")

    # -- client side -------------------------------------------------------
    def submit(self, prompt: str, meta: Optional[dict] = None,
               timeout_s: float = 60.0):
        """Enqueue one request and block until its ServeResult is ready.
        Returns None if the batch failed (see ``stats()['errors']``) or
        the timeout elapsed."""
        p = self._mb.submit(prompt, meta)
        p.done.wait(timeout_s)
        return p.result

    def submit_many(self, prompts: Sequence[str],
                    metas: Optional[Sequence[Optional[dict]]] = None,
                    timeout_s: float = 60.0):
        """Enqueue a pre-formed group; blocks until every result is in.

        Unlike :meth:`submit` from N threads, this hands the collector the
        whole group at once, so it batches without waiting ``max_wait``.
        """
        metas = list(metas) if metas is not None else [None] * len(prompts)
        pending = [self._mb.submit(p, m) for p, m in zip(prompts, metas)]
        for p in pending:
            p.done.wait(timeout_s)
        return [p.result for p in pending]

    def feedback(self, result, ok: bool) -> bool:
        """Operator error feedback on a served answer (DESIGN.md §17):
        pass the ``ServeResult`` (or its ``meta['adapt_seq']`` int) and
        whether the answer was right. A wrong-answer report rewrites
        the threshold controller's window-row label, so the next shadow
        sweep scores serving that query as an error. No-op (False)
        without an adaptive controller or once the row has rotated out
        of the bounded window."""
        fb = getattr(self.policy, "feedback", None)
        if fb is None:
            return False
        seq = result if isinstance(result, int) \
            else (getattr(result, "meta", None) or {}).get("adapt_seq", 0)
        if not seq:
            return False
        return bool(fb(seq, ok))

    # -- collector callback ------------------------------------------------
    def _serve(self, batch: List[_PendingRequest]):
        try:
            results = self.policy.serve_batch(
                [p.prompt for p in batch], [p.meta for p in batch])
        except Exception as e:  # noqa: BLE001 — count, then fail the batch
            with self._lock:
                self._errors += len(batch)
                self._last_error = repr(e)
            raise
        now = time.monotonic()
        with self._lock:
            self._batches += 1
            self._batched_requests += len(batch)
            self._requests += len(batch)
            for p, r in zip(batch, results):
                p.result = r
                self._latencies.append(now - p.enq_t)
                self._tier_counts[r.served_by] = \
                    self._tier_counts.get(r.served_by, 0) + 1
                self._static_origin += bool(r.static_origin)
                # rewritten serves are promoted content too (§18): the
                # tailored variant entered the tier via a verdict
                self._promoted += (r.served_by in ("dynamic", "rewritten")
                                   and bool(r.static_origin))
                self._stale += bool(r.meta.get("stale"))
                self._bypassed += r.meta.get("bypass") == "volatile"

    # -- telemetry ---------------------------------------------------------
    def stats(self) -> dict:
        import numpy as np
        with self._lock:
            lat = np.asarray(self._latencies, np.float64)
            n = max(self._requests, 1)
            describe = getattr(self.policy, "describe_index", None)
            dyn_describe = getattr(self.policy, "describe_dyn_index",
                                   None)
            out = {
                "requests": self._requests,
                "batches": self._batches,
                # which static-tier index serves the lookups (flat exact
                # vs injected ANN — DESIGN.md §11)
                "static_index": describe() if describe else "unknown",
                # dynamic-tier lookup path (flat masked scan vs the
                # segmented incremental index — DESIGN.md §12)
                "dynamic_index": dyn_describe() if dyn_describe
                else "unknown",
                "mean_batch_size": round(
                    self._batched_requests / max(self._batches, 1), 2),
                # hit-source mix (DESIGN.md §16): the L1 exact front,
                # the two semantic tiers (dynamic split by content
                # origin), and the backend — plus the freshness flags
                "l1_hit_rate": self._tier_counts["l1"] / n,
                "static_hit_rate": self._tier_counts["static"] / n,
                "dynamic_hit_rate": self._tier_counts["dynamic"] / n,
                "rewritten_hit_rate": self._tier_counts["rewritten"] / n,
                "promoted_hit_rate": self._promoted / n,
                "backend_rate": self._tier_counts["backend"] / n,
                "static_origin_rate": self._static_origin / n,
                "stale_serve_rate": self._stale / n,
                "bypassed_volatile": self._bypassed,
                "errors": self._errors,
            }
            # freshness-layer counters owned by the policy (L1 probes,
            # volatile bypasses, TTL deaths) — surfaced when present
            for name, attr in (("l1_hits", "_l1_hits"),
                               ("l1_bypass_volatile", "_l1_bypass"),
                               ("stale_serves", "_stale_serves"),
                               ("ttl_evictions", "_ttl_evictions")):
                v = getattr(self.policy, attr, None)
                if v is not None:
                    out[name] = int(v)
            l1 = getattr(self.policy, "l1", None)
            if l1 is not None:
                out["l1_entries"] = l1.stats()["l1_entries"]
            shard_stats = getattr(self.policy, "shard_stats", None)
            shard_stats = shard_stats() if shard_stats else None
            if shard_stats is not None:
                # mesh-serving layout (DESIGN.md §13): how many shards
                # the tiers are row-partitioned over, and how the live
                # dynamic entries spread across them
                out["shards"] = shard_stats["shards"]
                out["shard_occupancy"] = shard_stats["shard_occupancy"]
            dyn_stats = getattr(self.policy, "dyn_index_stats", None)
            dyn_stats = dyn_stats() if dyn_stats else None
            if dyn_stats is not None:
                # segment/tail occupancy + compaction counters
                # (SegmentedIndex.stats, DESIGN.md §12)
                out["dyn_tail_live"] = dyn_stats["tail_live"]
                out["dyn_segments"] = dyn_stats["segments"]
                out["dyn_segment_live"] = dyn_stats["segment_live"]
                out["dyn_seals"] = dyn_stats["seals"]
                out["dyn_merges"] = dyn_stats["merges"]
                out["dyn_tombstones"] = dyn_stats["tombstones"]
            pool = getattr(self.policy, "pool", None)
            if pool is not None and hasattr(pool, "depth"):
                # async VerifyAndPromote backlog (DESIGN.md §4/§14):
                # the load harness tracks this over time — depth only
                # delays promotions, never serving
                depth = pool.depth()
                out["judge_queued"] = depth["queued"]
                out["judge_inflight"] = depth["inflight"]
                # per-outcome verdict counters (§18): how the judged
                # grey-zone tasks resolved, plus the rewrite-path
                # degradation counts
                ps = getattr(pool, "stats", None)
                if ps is not None:
                    for name in ("approved", "rejected", "rewritten",
                                 "rewrite_failed",
                                 "rewrite_rate_limited"):
                        v = getattr(ps, name, None)
                        if v is not None:
                            out[f"judge_{name}"] = int(v)
            wal = getattr(self.policy, "wal", None)
            if wal is not None:
                out["wal_seq"] = wal.stats()["seq"]
            adaptive = getattr(self.policy, "adaptive", None)
            if adaptive is not None:
                # online threshold controller (DESIGN.md §17): live
                # per-segment operating points, window fill, and the
                # regret-style counters (shadow hits the pinned point
                # left on the table vs the measured frontier)
                out.update(adaptive.stats())
            if self._last_error:
                out["last_error"] = self._last_error
            if lat.size:
                out["p50_latency_ms"] = round(
                    1e3 * float(np.percentile(lat, 50)), 3)
                out["p99_latency_ms"] = round(
                    1e3 * float(np.percentile(lat, 99)), 3)
        return out

    def stop(self):
        self._mb.stop()
