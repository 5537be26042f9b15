"""Tiered semantic cache state: read-only static tier + mutable dynamic
tier (fixed-capacity struct-of-arrays with LRU eviction and upsert).

Port of ``repro/core/tiers.py``. The JAX tier is functional (every
mutation returns a new pytree); here the writers update the tier's
tensors IN PLACE and return the same tier object, which saves a copy of
every field per write.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.device import get_device
from repro_torch.index.flat import l2_normalize

BIG = 2**30


@dataclass
class StaticTier:
    """Read-only curated tier. emb rows are L2-normalized."""
    emb: torch.Tensor         # (S, d) fp32
    cls: torch.Tensor         # (S,) int32 — equivalence class of the answer
    answer_ref: torch.Tensor  # (S,) int32 — handle to the curated answer


@dataclass
class DynamicTier:
    """Mutable tier: fixed capacity C, LRU clocks, provenance bits."""
    emb: torch.Tensor            # (C, d) fp32, normalized
    cls: torch.Tensor            # (C,) int32 answer class
    answer_ref: torch.Tensor     # (C,) int32
    static_origin: torch.Tensor  # (C,) bool — auxiliary-overwrite entry
    valid: torch.Tensor          # (C,) bool
    last_used: torch.Tensor      # (C,) int32 LRU clock
    written_at: torch.Tensor     # (C,) int32 timestamp (LWW guard)
    expires_at: torch.Tensor     # (C,) int32 per-entry expiry; 0 = never
    # An entry is live while ``now <= expires_at`` (or expires_at == 0).


def _as(x, dtype, device) -> torch.Tensor:
    return torch.as_tensor(x).to(device=device, dtype=dtype)


def make_static_tier(emb, cls, answer_ref=None, device=None) -> StaticTier:
    """Static tier on ``device`` (default ``cuda``); rows are normalized
    here."""
    dev = get_device(device)
    emb = _as(emb, torch.float32, dev)
    if answer_ref is None:
        answer_ref = torch.arange(emb.shape[0], dtype=torch.int32,
                                  device=dev)
    return StaticTier(l2_normalize(emb).contiguous(),
                      _as(cls, torch.int32, dev),
                      _as(answer_ref, torch.int32, dev))


def make_dynamic_tier(capacity: int, d: int, device=None) -> DynamicTier:
    dev = get_device(device)

    def z(dtype):
        return torch.zeros((capacity,), dtype=dtype, device=dev)
    return DynamicTier(
        emb=torch.zeros((capacity, d), dtype=torch.float32, device=dev),
        cls=z(torch.int32),
        answer_ref=torch.full((capacity,), -1, dtype=torch.int32,
                              device=dev),
        static_origin=z(torch.bool), valid=z(torch.bool),
        last_used=z(torch.int32), written_at=z(torch.int32),
        expires_at=z(torch.int32))


def live_mask(tier: DynamicTier, now=None) -> torch.Tensor:
    """(C,) bool: valid AND not past the per-entry expiry. ``now=None``
    skips the expiry test. Live iff ``expires_at == 0 or now <=
    expires_at``."""
    if now is None:
        return tier.valid
    alive = (tier.expires_at == 0) | (int(now) <= tier.expires_at)
    return tier.valid & alive


# ---------------------------------------------------------------------------
# lookups
# ---------------------------------------------------------------------------

def static_lookup(tier: StaticTier, q: torch.Tensor):
    """q (d,) normalized -> (best similarity, best index), 0-d tensors."""
    sims = tier.emb @ q
    idx = torch.argmax(sims)
    return sims[idx], idx.to(torch.int32)


def dynamic_lookup(tier: DynamicTier, q: torch.Tensor, now=None):
    """q (d,) normalized -> (best similarity, best index) over live rows."""
    sims = torch.where(live_mask(tier, now), tier.emb @ q,
                       torch.tensor(float("-inf"), device=q.device))
    idx = torch.argmax(sims)
    return sims[idx], idx.to(torch.int32)


def static_lookup_batch(tier: StaticTier, q: torch.Tensor):
    """q (B, d) normalized -> (best sims (B,), best idx (B,)): one fused
    exact top-1 pass over the micro-batch through ``kernels/simsearch``
    (the CUDA kernel on the card, its plain version on the CPU)."""
    from repro_torch.kernels.simsearch.ops import cosine_topk
    vals, idx = cosine_topk(q, tier.emb, k=1)
    return vals[:, 0], idx[:, 0]


def dynamic_lookup_batch(tier: DynamicTier, q: torch.Tensor):
    """Batched twin of :func:`dynamic_lookup`: one masked matmul for the
    micro-batch. q (B, d) L2-normalized -> (best sims (B,), best idx)."""
    sims = torch.where(tier.valid[None, :], q @ tier.emb.T,
                       torch.tensor(float("-inf"), device=q.device))
    idx = torch.argmax(sims, dim=1)
    return (torch.gather(sims, 1, idx[:, None])[:, 0],
            idx.to(torch.int32))


# ---------------------------------------------------------------------------
# mutations (in place; each returns the tier it was given)
# ---------------------------------------------------------------------------

def _lru_slot(tier: DynamicTier, cap=None, now=None) -> int:
    """Insertion slot: first non-live row, else least-recently-used.
    ``cap`` restricts the choice to rows ``[0, cap)``; ``now`` treats
    TTL-expired rows as free."""
    key = torch.where(live_mask(tier, now), tier.last_used.to(torch.int64),
                      -BIG)
    if cap is not None:
        rows = torch.arange(key.shape[0], device=key.device)
        key = torch.where(rows < cap, key, BIG)
    return int(torch.argmin(key))


def _write(tier: DynamicTier, slot, q, cls, answer_ref, static_origin,
           now, last_used=None, expires=0) -> DynamicTier:
    """Write one row in place. ``now`` stamps ``written_at`` (the LWW
    clock); ``last_used`` (default ``now``) stamps the LRU clock;
    ``expires`` the per-entry expiry (0 = never)."""
    slot = int(slot)
    tier.emb[slot] = torch.as_tensor(q, dtype=torch.float32)
    tier.cls[slot] = int(cls)
    tier.answer_ref[slot] = int(answer_ref)
    tier.static_origin[slot] = bool(static_origin)
    tier.valid[slot] = True
    tier.last_used[slot] = int(now if last_used is None else last_used)
    tier.written_at[slot] = int(now)
    tier.expires_at[slot] = int(expires)
    return tier


def insert(tier: DynamicTier, q, cls, answer_ref, now,
           static_origin=False, cap=None, expires=0) -> DynamicTier:
    """Baseline write-back (Alg. 1 line 11): plain LRU insert."""
    return _write(tier, _lru_slot(tier, cap, now), q, cls, answer_ref,
                  static_origin, now, expires=expires)


def upsert(tier: DynamicTier, q, cls, answer_ref, now,
           static_origin=True, dedup_sim: float = 0.9999,
           lww: bool = True, cap=None, last_used=None,
           expires=0) -> DynamicTier:
    """Auxiliary overwrite (Alg. 2 line 21): idempotent, LWW-guarded.

    A near-identical live key (sim >= dedup_sim) is overwritten in
    place, else the LRU slot is taken. With ``lww`` an existing newer
    entry (``written_at > now``) is left alone. ``now`` is the enqueue
    time (LWW clock), ``last_used`` the live clock at apply time."""
    s, j = dynamic_lookup(tier, q, now=last_used)
    dup = bool(s >= dedup_sim)
    j = int(j)
    if lww and dup and int(tier.written_at[j]) > now:
        return tier
    slot = j if dup else _lru_slot(tier, cap, now=last_used)
    return _write(tier, slot, q, cls, answer_ref, static_origin, now,
                  last_used=last_used, expires=expires)


def touch(tier: DynamicTier, slot, now) -> DynamicTier:
    """LRU touch on hit."""
    tier.last_used[int(slot)] = int(now)
    return tier


def touch_many(tier: DynamicTier, slots, nows) -> DynamicTier:
    """Batched LRU touch: one scatter for a micro-batch of hits. Callers
    deduplicate ``slots``: the order of duplicate writes is unspecified."""
    dev = tier.last_used.device
    tier.last_used[torch.as_tensor(slots, dtype=torch.int64, device=dev)] = \
        torch.as_tensor(nows, dtype=torch.int32, device=dev)
    return tier


def evict_expired(tier: DynamicTier, now,
                  ttl: int | None = None) -> DynamicTier:
    """TTL sweep: invalidate entries past their per-entry ``expires_at``.

    ``ttl=None``: expired iff ``expires_at > 0 and now > expires_at``.
    Legacy global ``ttl``: expired iff ``now - written_at > ttl``;
    ``ttl=0`` means TTL is disabled and the sweep is a no-op."""
    if ttl is not None:
        if ttl == 0:
            return tier
        alive = int(now) - tier.written_at <= ttl
    else:
        alive = (tier.expires_at == 0) | (int(now) <= tier.expires_at)
    tier.valid &= alive
    return tier


@dataclass(frozen=True)
class CacheConfig:
    """Thresholds + capacities for the tiered cache (a copy of
    ``repro.core.tiers.CacheConfig``; see its field notes)."""
    tau_static: float
    tau_dynamic: float
    sigma_min: float = 0.0      # grey-zone lower cutoff (paper: 0)
    capacity: int = 4096
    judge_latency: int = 64     # async completion lag, in requests
    ttl: int = 0                # 0 = disabled
    dedup: bool = True          # skip judging when a promoted pointer hits
    judge_rate: float = 1.0     # judge token-bucket refill per request
    l1: bool = False
    volatile_bypass: bool = False
    ttl_volatile: int = 0
    ttl_stable: int = 0
    dup_threshold: float = 0.9999
    rewrite: bool = False
    rewrite_rate: float = 1.0

    def __post_init__(self):
        if not (0.0 < self.dup_threshold <= 1.0):
            raise ValueError(
                f"dup_threshold={self.dup_threshold} outside (0, 1]")
        if self.rewrite_rate < 0.0:
            raise ValueError(f"rewrite_rate={self.rewrite_rate} < 0")
        # tau_dynamic > 1 is the "dynamic tier unreachable" sentinel
        if self.dup_threshold < self.tau_dynamic <= 1.0:
            raise ValueError(
                f"dup_threshold={self.dup_threshold} < "
                f"tau_dynamic={self.tau_dynamic}: promotions for keys "
                "the tier already serves would duplicate rows")
