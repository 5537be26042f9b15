"""Asynchronous VerifyAndPromote worker pool (live serving path).

Implements the operational pipeline of §3.1: bounded queue, deduplication
of (query, static-neighbor) pairs, token-bucket rate limiting, retry with
exponential backoff, and straggler mitigation (a task past its deadline is
re-dispatched to another worker; first completion wins, idempotent upsert
makes the duplicate harmless).

The judge emits a structured ``Verdict`` (plain bools are auto-wrapped)
and the pool dispatches per outcome through an extensible action
registry: APPROVE and REWRITE both run the promote action by default
(the payload carries the outcome tag and the rewritten text, so the
policy's upsert knows which variant it is landing), REJECT runs none.
Retry/backoff and first-completion-wins apply identically to every
outcome — the action, not the verdict, is what retries.

Everything is off the serving path: ``submit`` never blocks and serving
never waits on this pool. Queue depth only delays promotions (§3.1).
"""
from __future__ import annotations

import heapq
import itertools
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

from repro_torch.core.judge import APPROVE, REJECT, REWRITE, as_verdict

# How long ``stop`` waits for each worker and the reaper to end.
STOP_JOIN_S = 5.0


@dataclass
class VerifyTask:
    key: tuple                  # dedup key: (q_fingerprint, h_idx)
    payload: dict
    attempts: int = 0
    enqueued_at: float = field(default_factory=time.monotonic)


@dataclass
class PoolStats:
    submitted: int = 0
    deduped: int = 0
    rate_limited: int = 0
    dropped_full: int = 0
    judged: int = 0
    approved: int = 0
    retried: int = 0
    redispatched: int = 0
    duplicate_completions: int = 0
    failed: int = 0
    # per-outcome counters (winning completions only — the same
    # accounting discipline `approved` always had)
    rejected: int = 0
    rewritten: int = 0
    # rewrite-path degradations: the judge said REWRITE but no tailored
    # text landed (rewriter missing/failed/empty -> rewrite_failed;
    # rewrite token bucket empty -> rewrite_rate_limited). Both
    # downgrade the verdict to REJECT and are also counted there.
    rewrite_failed: int = 0
    rewrite_rate_limited: int = 0


class VerifyAndPromotePool:
    """Background pool running judge -> verdict -> per-outcome actions."""

    def __init__(self,
                 judge_fn: Callable[[dict], object],
                 promote_fn: Callable[[dict], None],
                 n_workers: int = 2,
                 max_depth: int = 1024,
                 rate_per_s: float = float("inf"),
                 rate_per_req: float = 0.0,
                 max_attempts: int = 3,
                 backoff_s: float = 0.05,
                 straggler_deadline_s: float = 5.0,
                 actions: Optional[Dict[str, Callable]] = None):
        """``rate_per_s`` refills the token bucket by wall-clock time;
        ``rate_per_req`` additionally refills it per submission attempt
        — the live analogue of the simulator's per-request
        ``CacheConfig.judge_rate`` budget (core/simulate.py), which
        ``KritesPolicy`` threads through here by default.

        ``judge_fn`` may return a ``Verdict`` or a plain bool (wrapped
        via ``as_verdict``). ``actions`` maps verdict outcomes to the
        callable run for winning completions of that outcome; the
        default registry promotes APPROVE and REWRITE payloads (the
        promote callback reads the payload's outcome tag) and does
        nothing on REJECT. Extra outcomes just need a registry entry."""
        self.judge_fn = judge_fn
        self.promote_fn = promote_fn
        self.actions: Dict[str, Optional[Callable]] = {
            APPROVE: promote_fn,
            REWRITE: promote_fn,
            REJECT: None,
        }
        if actions:
            self.actions.update(actions)
        self.q: "queue.Queue[VerifyTask]" = queue.Queue(max_depth)
        self.stats = PoolStats()
        self._inflight: dict = {}
        # retry backoff is deadline-based, not sleep-based: a retrying
        # task parks here as (ready_at, seq, task) and is re-enqueued by
        # whichever worker/reaper loop next observes ready_at passed —
        # no worker slot blocks for the backoff duration
        self._delayed: list = []
        self._seq = itertools.count()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._rate = rate_per_s
        self._rate_req = rate_per_req
        self._tokens = float(min(rate_per_s, 1e9))
        self._last_refill = time.monotonic()
        self._max_attempts = max_attempts
        self._backoff = backoff_s
        self._deadline = straggler_deadline_s
        self._workers = [
            threading.Thread(target=self._run, daemon=True,
                             name=f"krites-judge-{i}")
            for i in range(n_workers)]
        for w in self._workers:
            w.start()
        self._reaper = threading.Thread(target=self._reap_stragglers,
                                        daemon=True)
        self._reaper.start()

    # -- producer side (called from the serving path; never blocks) -------
    def submit(self, key: tuple, payload: dict) -> bool:
        task = VerifyTask(key, payload)
        with self._lock:
            self.stats.submitted += 1
            if key in self._inflight:
                self.stats.deduped += 1
                return False
            if not self._take_token():
                self.stats.rate_limited += 1
                return False
            # [dispatch time, task, outstanding copies]: the reaper
            # re-dispatches a stuck task to another worker and bumps
            # the copy count; the key leaves the set when a copy wins
            # or every copy has terminally failed
            self._inflight[key] = [time.monotonic(), task, 1]
        try:
            self.q.put_nowait(task)
            return True
        except queue.Full:
            with self._lock:
                self.stats.dropped_full += 1
                self._inflight.pop(key, None)
            return False

    def submit_many(self, items) -> int:
        """Bulk submit for the batched serving path: one lock acquisition
        for a whole micro-batch of grey-zone triggers. ``items`` is an
        iterable of (key, payload); returns the number enqueued. Same
        dedup / token-bucket / drop-on-full semantics as :meth:`submit`,
        applied per item in order."""
        accepted = []
        with self._lock:
            for key, payload in items:
                self.stats.submitted += 1
                if key in self._inflight:
                    self.stats.deduped += 1
                    continue
                if not self._take_token():
                    self.stats.rate_limited += 1
                    continue
                task = VerifyTask(key, payload)
                self._inflight[key] = [time.monotonic(), task, 1]
                accepted.append(task)
        n = 0
        for task in accepted:
            try:
                self.q.put_nowait(task)
                n += 1
            except queue.Full:
                with self._lock:
                    self.stats.dropped_full += 1
                    self._inflight.pop(task.key, None)
        return n

    def _take_token(self) -> bool:
        now = time.monotonic()
        if self._rate == float("inf"):
            self._tokens = 1e9
        else:
            self._tokens = min(
                self._tokens + (now - self._last_refill) * self._rate
                + self._rate_req,
                max(self._rate, self._rate_req, 1.0))
        self._last_refill = now
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            return True
        return False

    # -- worker side -------------------------------------------------------
    def _flush_delayed(self) -> None:
        """Re-enqueue every parked retry whose backoff deadline passed.
        Called from the worker loops (<=0.1 s latency via the queue-get
        timeout) and the reaper sweep."""
        while True:
            with self._lock:
                if not self._delayed \
                        or self._delayed[0][0] > time.monotonic():
                    return
                _, _, task = heapq.heappop(self._delayed)
            try:
                self.q.put_nowait(task)
            except queue.Full:
                self._abandon_copy(task.key)

    def _run(self):
        while not self._stop.is_set():
            self._flush_delayed()
            try:
                task = self.q.get(timeout=0.1)
            except queue.Empty:
                continue
            try:
                verdict = as_verdict(self.judge_fn(task.payload))
                action = self.actions.get(verdict.outcome)
                with self._lock:
                    self.stats.judged += 1
                    # first completion wins: a re-dispatched duplicate
                    # arriving after the winner popped the key skips
                    # the action (which is idempotent anyway)
                    live = task.key in self._inflight
                if live and action is not None:
                    # idempotent upsert — safe under duplicate dispatch.
                    # The key stays inflight until the action lands,
                    # so a transient failure hits the retry path below
                    # instead of being dropped, and drain() keeps
                    # waiting through the backoff.
                    action(task.payload)
                with self._lock:
                    won = live and self._inflight.pop(task.key,
                                                      None) is not None
                    if not won:  # another copy won first
                        self.stats.duplicate_completions += 1
                    elif verdict.outcome == APPROVE:
                        self.stats.approved += 1
                    elif verdict.outcome == REWRITE:
                        self.stats.rewritten += 1
                    else:
                        self.stats.rejected += 1
                        # rewrite-path degradation flags stamped by the
                        # judge wrapper (policy._judge_payload)
                        if task.payload.get("rewrite_failed"):
                            self.stats.rewrite_failed += 1
                        if task.payload.get("rewrite_rate_limited"):
                            self.stats.rewrite_rate_limited += 1
            except Exception:  # noqa: BLE001 — transient failure: retry
                task.attempts += 1
                if task.attempts < self._max_attempts:
                    # deadline-based requeue: park the task until its
                    # backoff expires (no worker sleeps) and push the
                    # inflight dispatch clock to that deadline, so the
                    # straggler reaper — which fires on `now - e[0] >
                    # deadline` — cannot re-dispatch a task that is
                    # merely backing off (duplicate judge calls,
                    # inflated copy counts)
                    ready_at = time.monotonic() \
                        + self._backoff * (2 ** task.attempts)
                    with self._lock:
                        self.stats.retried += 1
                        entry = self._inflight.get(task.key)
                        if entry is not None:
                            entry[0] = ready_at
                        heapq.heappush(self._delayed,
                                       (ready_at, next(self._seq), task))
                else:
                    self._abandon_copy(task.key)

    def _abandon_copy(self, key: tuple) -> None:
        """One copy of an inflight task failed terminally. The key only
        leaves the set when no copy remains, so a failed re-dispatched
        duplicate cannot orphan a straggler that later completes."""
        with self._lock:
            entry = self._inflight.get(key)
            if entry is None:
                return            # another copy already completed it
            self.stats.failed += 1
            entry[2] -= 1
            if entry[2] <= 0:
                self._inflight.pop(key, None)

    def _reap_stragglers(self):
        """Re-dispatch tasks stuck past the deadline to another worker
        (straggler mitigation, §3.1): a duplicate of the stuck task is
        re-enqueued; whichever copy completes first pops the inflight
        key and wins, the loser sees the key gone and skips the
        (idempotent) promote."""
        while not self._stop.is_set():
            self._stop.wait(self._deadline / 2)
            self._flush_delayed()
            now = time.monotonic()
            with self._lock:
                stuck = [(k, e) for k, e in self._inflight.items()
                         if now - e[0] > self._deadline]
                for _, e in stuck:
                    e[0] = now
            for k, e in stuck:
                dup = VerifyTask(k, e[1].payload, attempts=e[1].attempts)
                try:
                    self.q.put_nowait(dup)
                    with self._lock:
                        self.stats.redispatched += 1
                        entry = self._inflight.get(k)
                        if entry is not None:
                            entry[2] += 1
                except queue.Full:
                    pass   # still tracked; next sweep retries

    def depth(self) -> dict:
        """Live queue-depth telemetry (the load harness plots this over
        time — queue depth only delays promotions, §3.1): tasks waiting
        in the queue and keys dispatched but not yet completed."""
        with self._lock:
            return {"queued": self.q.qsize(),
                    "inflight": len(self._inflight),
                    "backing_off": len(self._delayed)}

    def drain(self, timeout_s: float = 30.0):
        """Block until the queue is empty (tests / shutdown only)."""
        t0 = time.monotonic()
        while (not self.q.empty() or self._inflight) \
                and time.monotonic() - t0 < timeout_s:
            time.sleep(0.01)

    def stop(self):
        """Stop the workers and the reaper and join them (each waits at
        most ``STOP_JOIN_S``: a worker inside a judge call finishes it)."""
        self._stop.set()
        for th in (*self._workers, self._reaper):
            if th is not threading.current_thread():
                th.join(STOP_JOIN_S)
