"""L1 exact-match front tier: canonicalized query -> answer (DESIGN.md §16).

The cheapest large win at production repeat rates: a byte-identical (up
to canonicalization) repeat should not pay the embedder or either
semantic lookup. This tier fronts ``BaselinePolicy``/``KritesPolicy``
on both serve paths with an O(1) dict probe keyed by the *canonical
form* of the prompt:

    NFC unicode normalization -> casefold -> whitespace collapse

Equal canonical forms always alias (one entry); distinct canonical
forms never collide — the dict's hash buckets are resolved by full-key
equality, so a hash collision degrades to a probe, never to a wrong
answer. Entries are LRU-capped (``OrderedDict`` move-to-end on hit)
and carry a per-entry ``expires_at`` in the policy's request-tick
clock (0 = never): an entry is servable while ``now <= expires_at``
and dead strictly after — the same liveness rule as the dynamic tier's
``expires_at`` column.

The tier caches *whatever the policy served* (static hit, dynamic hit,
or backend answer) together with its provenance (``static_origin``)
and the serve-time content clock (``content_t`` — when the cached
answer was generated; 0 for curated static answers), which the
freshness layer (``core/freshness.py``) uses for drift/staleness
accounting. Thread-safe: the router's micro-batcher and scalar callers
may probe concurrently.
"""
from __future__ import annotations

import threading
import unicodedata
from collections import OrderedDict
from dataclasses import dataclass


def canonicalize(text: str) -> str:
    """Canonical form: NFC -> casefold -> whitespace collapse.

    ``casefold`` (not ``lower``) so e.g. ``ß``/``ss`` alias; NFC so
    composed and decomposed accents alias; ``split()`` collapses every
    unicode whitespace run (tabs, NBSP after NFC, newlines) to a single
    space and strips the ends.
    """
    return " ".join(unicodedata.normalize("NFC", str(text))
                    .casefold().split())


@dataclass
class L1Entry:
    """One cached serve outcome, keyed by canonical prompt."""
    answer: object
    static_origin: bool = False
    content_t: int = 0      # request tick the answer content dates from
    expires_at: int = 0     # 0 = never; live while now <= expires_at
    written_at: int = 0     # tick the entry was inserted


class ExactTier:
    """LRU-capped exact-match cache with per-entry expiry."""

    def __init__(self, capacity: int = 4096):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = int(capacity)
        self._od: "OrderedDict[str, L1Entry]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.puts = 0
        self.ttl_evictions = 0
        self.lru_evictions = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._od)

    def get(self, key: str, now: int) -> L1Entry | None:
        """O(1) probe. A hit moves the entry to the LRU head; an
        expired entry (``now > expires_at > 0``) is dropped on touch
        and counts as a TTL eviction + miss."""
        with self._lock:
            e = self._od.get(key)
            if e is None:
                self.misses += 1
                return None
            if 0 < e.expires_at < now:
                del self._od[key]
                self.ttl_evictions += 1
                self.misses += 1
                return None
            self._od.move_to_end(key)
            self.hits += 1
            return e

    def put(self, key: str, answer, *, static_origin: bool = False,
            content_t: int = 0, expires_at: int = 0,
            now: int = 0) -> None:
        """Insert/overwrite; evicts the LRU tail past capacity."""
        with self._lock:
            self._od[key] = L1Entry(answer, bool(static_origin),
                                    int(content_t), int(expires_at),
                                    int(now))
            self._od.move_to_end(key)
            self.puts += 1
            while len(self._od) > self.capacity:
                self._od.popitem(last=False)
                self.lru_evictions += 1

    def sweep(self, now: int) -> int:
        """Drop every expired entry; returns how many died."""
        with self._lock:
            dead = [k for k, e in self._od.items()
                    if 0 < e.expires_at < now]
            for k in dead:
                del self._od[k]
            self.ttl_evictions += len(dead)
            return len(dead)

    def stats(self) -> dict:
        with self._lock:
            return {"l1_entries": len(self._od),
                    "l1_capacity": self.capacity,
                    "l1_hits": self.hits, "l1_misses": self.misses,
                    "l1_puts": self.puts,
                    "l1_ttl_evictions": self.ttl_evictions,
                    "l1_lru_evictions": self.lru_evictions}

    # -- persistence (serving/persist.py snapshots) ---------------------

    def to_state(self) -> list:
        """JSON-serializable dump in LRU order (oldest first)."""
        with self._lock:
            return [[k, e.answer if isinstance(e.answer, str)
                     else str(e.answer), bool(e.static_origin),
                     int(e.content_t), int(e.expires_at),
                     int(e.written_at)]
                    for k, e in self._od.items()]

    def load_state(self, state: list, *, now: int = 0) -> int:
        """Rebuild from :meth:`to_state`, dropping entries already past
        their expiry at restore time — expired entries must not
        resurrect on warm restore (DESIGN.md §16). Returns the live
        count installed."""
        with self._lock:
            self._od.clear()
            for k, ans, so, ct, exp, wr in state:
                if 0 < exp < now:
                    continue
                self._od[k] = L1Entry(ans, bool(so), int(ct), int(exp),
                                      int(wr))
            while len(self._od) > self.capacity:
                self._od.popitem(last=False)
            return len(self._od)
