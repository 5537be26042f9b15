"""Staleness-risk classifier + TTL assignment (DESIGN.md §16).

Freshness-sensitive traffic ("what is the price of X *now*") is the
one scenario axis where serving a semantically-correct cached answer
is still wrong: the ground truth rotates under the cache. This module
is the serve-path half of the freshness subsystem:

- :func:`classify` buckets a prompt into VOLATILE / STABLE / UNKNOWN
  by keyword classes over its canonical token stream (the
  ``semantic-llm-cache`` exemplar's heuristic — cheap enough for the
  critical path, no model call).
- :class:`FreshnessPolicy` maps the class to a cache-life decision:
  volatile queries either bypass caching entirely
  (``volatile_bypass``) or get a short per-entry TTL; stable/unknown
  queries get their own (usually 0 = unbounded) TTLs. The same policy
  object backs the judge's TTL verdict on the async promotion path
  (``OracleJudge.assign_ttl``), so L1 entries, write-back inserts and
  verified promotions all expire on one rule.
- Drift accounting: with a ``drift_every`` epoch clock, a served hit
  is *stale* when the query is volatile and the answer's content
  timestamp falls in an earlier epoch than the serve tick
  (``content_t // drift_every != now // drift_every``). This is a
  property of the two clocks only — no ground truth needed live — and
  matches the simulator's ``stale_serve`` outcome bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.exact_tier import canonicalize

VOLATILE = "volatile"
STABLE = "stable"
UNKNOWN = "unknown"

# Single-token triggers over the canonical (casefolded) token stream.
VOLATILE_KEYWORDS = frozenset({
    "now", "today", "tonight", "latest", "current", "currently",
    "price", "prices", "stock", "stocks", "weather", "forecast",
    "news", "score", "scores", "live", "breaking", "recent",
    "yesterday", "tomorrow", "schedule", "open", "hours", "rate",
    "rates", "trending", "update", "updates",
})
STABLE_KEYWORDS = frozenset({
    "definition", "define", "meaning", "history", "formula",
    "theorem", "capital", "biography", "origin", "etymology",
    "boiling", "synonym", "antonym", "spelled", "spelling",
})


def classify(text: str) -> str:
    """Keyword staleness-risk class of a prompt: VOLATILE if any
    volatile trigger appears, else STABLE on a stable trigger, else
    UNKNOWN. Operates on canonical tokens, so case/whitespace/unicode
    phrasing does not change the class."""
    toks = set(canonicalize(text).split())
    if toks & VOLATILE_KEYWORDS:
        return VOLATILE
    if toks & STABLE_KEYWORDS:
        return STABLE
    return UNKNOWN


@dataclass(frozen=True)
class FreshnessPolicy:
    """Class -> cache-life mapping, in request ticks.

    ``ttl_* = 0`` means unbounded (never expires), mirroring
    ``CacheConfig.ttl``'s contract. ``volatile_bypass=True`` takes
    volatile queries out of the cache entirely (no L1 read/write, no
    semantic lookups, no write-back, no grey-zone submission — the
    answer goes straight to the backend), trading latency for a
    guaranteed zero stale serves on that class. ``drift_every`` is the
    epoch clock used only for stale *accounting* of volatile hits; it
    does not change serving decisions.
    """
    volatile_bypass: bool = True
    ttl_volatile: int = 64
    ttl_stable: int = 0
    ttl_unknown: int = 0
    drift_every: int = 0
    keywords_volatile: frozenset = field(default=VOLATILE_KEYWORDS)
    keywords_stable: frozenset = field(default=STABLE_KEYWORDS)

    def classify(self, text: str) -> str:
        toks = set(canonicalize(text).split())
        if toks & self.keywords_volatile:
            return VOLATILE
        if toks & self.keywords_stable:
            return STABLE
        return UNKNOWN

    def is_volatile(self, text: str) -> bool:
        return self.classify(text) == VOLATILE

    def ttl_for(self, fclass: str) -> int:
        if fclass == VOLATILE:
            return int(self.ttl_volatile)
        if fclass == STABLE:
            return int(self.ttl_stable)
        return int(self.ttl_unknown)

    def ttl_for_text(self, text: str) -> int:
        return self.ttl_for(self.classify(text))

    def expires_at(self, text: str, now: int) -> int:
        """Per-entry expiry stamp for a write at tick ``now`` (0 =
        never)."""
        ttl = self.ttl_for_text(text)
        return int(now) + ttl if ttl > 0 else 0

    def is_stale(self, text_volatile: bool, content_t: int,
                 now: int) -> bool:
        """Drift-clock staleness of a hit served at ``now`` whose
        answer content dates from ``content_t``."""
        d = int(self.drift_every)
        if d <= 0 or not text_volatile:
            return False
        return (int(content_t) // d) != (int(now) // d)
