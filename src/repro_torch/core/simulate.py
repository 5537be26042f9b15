"""Trace-driven simulator for Algorithm 1 (baseline) and Algorithm 2
(Krites), plus ``simulate_sweep``, which evaluates a whole grid of
configs in one pass over the trace (port of ``repro/core/simulate.py``).

Faithful to the paper's evaluation (§4):
- serving decisions use fixed thresholds tau_static / tau_dynamic;
- Krites only adds the grey-zone trigger + an asynchronous
  VerifyAndPromote whose judge is the *oracle* over ground-truth
  equivalence classes (approve iff query and static neighbor share a
  class);
- the async pool is modeled as a fixed-size pending ring: a task
  enqueued at request t carries ``due_at = t + judge_latency`` and is
  completed at the first step >= due_at, at most one completion per step
  (queue depth affects promotion lag only — never the serving decision
  of the triggering request, which is decided before the queue is
  touched).

The reference runs each core as one ``lax.scan``. Here the step loop is
a Python loop over tensor ops on ``device`` (default ``cuda``): the
request clock ``t`` and every value read from the trace (classes,
volatility, keys, flips) are host values, so no step waits on the
device; everything that depends on the cache state stays in tensors,
with ``torch.where`` in place of branches and the (K, C) carries
updated in place by one-row-per-config scatters. Per-step outputs are
stacked once per window of ``_BLOCK`` steps.

The static-tier lookup is hoisted out of the loop (the static tier is
immutable) into one fp32 matmul + argmax over 2048-row chunks, shared
across every swept config, exactly as the reference computes it; the
per-step dynamic lookup stays inside the loop because the tier mutates.

Per config, the outputs equal the reference's field by field whenever
every similarity is exact in fp32 (the dyadic traces of
``tests/test_torch_simulate.py``); on float traces a decision can differ
only where a score sits within rounding of a threshold or a tie.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import tiers as T
from repro_torch.device import get_device

# served-by codes in the event stream
MISS, STATIC_HIT, DYN_HIT_DYNAMIC, DYN_HIT_PROMOTED, L1_HIT = 0, 1, 2, 3, 4
# a dynamic-tier hit on a REWRITE-promoted tailored variant; its
# answer_ref carries the -2 sentinel
REWRITTEN_HIT = 5

# "never expires" sentinel for the sim's L1 expiry column (0 = empty
# slot; request clocks are bounded by the trace length, far below 2**30)
_L1_NEVER = 1 << 30

_BLOCK = 64  # blocked-core window; per-block sims buffer = 2*B*K*C fp32
_NEG_INF = float("-inf")


class SimState(NamedTuple):
    """Loop carry: every tensor has a leading (K,) config axis.

    ``t`` is the host request clock. The pending VerifyAndPromote queue
    is a *bit ring* of R slots: bit (k, t mod R) records whether config k
    enqueued a task at step t; the task's payload is request t of the
    shared trace, re-gathered at completion time. The L1 exact-match
    front carries four (K, nk) columns keyed by the trace's ``key_id``:
    the entry's expiry clock (0 = empty), the content clock its answer
    was produced at, and the stored correctness/provenance bits.
    """
    dyn: T.DynamicTier   # batched: (K, C, d) / (K, C) fields
    ring: torch.Tensor      # (K, R) bool enqueue bits
    budget: torch.Tensor    # (K,) f32 token bucket for judge rate limiting
    t: int
    judge_calls: torch.Tensor     # (K,) i32
    judge_approved: torch.Tensor  # (K,)
    promotions: torch.Tensor      # (K,)
    enq_dropped: torch.Tensor     # (K,)
    l1_exp: torch.Tensor          # (K, nk) i32 expiry (0 = empty slot)
    l1_w: torch.Tensor            # (K, nk) i32 content clock
    l1_ok: torch.Tensor           # (K, nk) bool stored correctness
    l1_so: torch.Tensor           # (K, nk) bool stored static_origin
    ttl_evicted: torch.Tensor     # (K,) dynamic entries dead by expiry
    bypassed: torch.Tensor        # (K,) volatile requests sent straight back
    rbud: torch.Tensor            # (K,) f32 token bucket for rewrites
    rewrites: torch.Tensor        # (K,) REWRITE verdicts promoted
    rewrite_dropped: torch.Tensor  # (K,) rewrites lost to an empty bucket


class SimResult(NamedTuple):
    served_by: torch.Tensor       # (N,) int8 event codes ((K, N) for sweeps)
    correct: torch.Tensor         # (N,) bool (True for misses too)
    static_origin: torch.Tensor   # (N,) bool — curated answer served
    stale: torch.Tensor           # (N,) bool — hit served across a drift
    judge_calls: torch.Tensor     # epoch
    judge_approved: torch.Tensor
    promotions: torch.Tensor
    enq_dropped: torch.Tensor
    ttl_evicted: torch.Tensor
    bypassed: torch.Tensor
    # rewrite pipeline counters; defaulted so hand-built SimResults
    # without them keep working
    rewrites: torch.Tensor = torch.tensor(0, dtype=torch.int32)
    rewrite_dropped: torch.Tensor = torch.tensor(0, dtype=torch.int32)


class SweepConfig(NamedTuple):
    """One row per config; every field is a (K,) tensor (on the host as
    :func:`sweep_from_configs` builds it; ``simulate_sweep`` moves it).

    Each scalar maps onto the matching :class:`tiers.CacheConfig` field;
    ``krites`` is the Algorithm-1-vs-2 switch (the grey-zone trigger),
    swept like any other knob so baseline and Krites share one pass.
    """
    tau_static: torch.Tensor    # (K,) f32
    tau_dynamic: torch.Tensor   # (K,) f32
    sigma_min: torch.Tensor     # (K,) f32
    judge_rate: torch.Tensor    # (K,) f32
    capacity: torch.Tensor      # (K,) i32, each <= the tier's rows
    judge_latency: torch.Tensor  # (K,) i32, each <= the ring size
    krites: torch.Tensor        # (K,) bool
    dedup: torch.Tensor         # (K,) bool — skip judging on promoted hits
    l1: torch.Tensor            # (K,) bool — exact-match front tier on
    volatile_bypass: torch.Tensor  # (K,) bool — volatile queries skip cache
    ttl_volatile: torch.Tensor  # (K,) i32 entry lifetime, volatile queries
    ttl_stable: torch.Tensor    # (K,) i32 entry lifetime, everything else
    dup_threshold: torch.Tensor  # (K,) f32 promotion near-dup overwrite gate
    rewrite: torch.Tensor       # (K,) bool — rewrite outcome on
    rewrite_rate: torch.Tensor  # (K,) f32 rewrite token budget per request

    @property
    def n(self) -> int:
        return int(self.tau_static.shape[0])


def sweep_from_configs(cfgs: Sequence[T.CacheConfig],
                       krites) -> SweepConfig:
    """Pack CacheConfigs (+ per-config or shared ``krites`` flag) into a
    SweepConfig of host tensors."""
    kr = np.broadcast_to(np.asarray(krites, bool), (len(cfgs),))

    def col(name, dtype, default=None):
        return torch.tensor([getattr(c, name, default) for c in cfgs],
                            dtype=dtype)
    f32, i32, b = torch.float32, torch.int32, torch.bool
    return SweepConfig(
        tau_static=col("tau_static", f32), tau_dynamic=col("tau_dynamic", f32),
        sigma_min=col("sigma_min", f32), judge_rate=col("judge_rate", f32),
        capacity=col("capacity", i32), judge_latency=col("judge_latency", i32),
        krites=torch.tensor(kr.copy()), dedup=col("dedup", b),
        l1=col("l1", b), volatile_bypass=col("volatile_bypass", b),
        ttl_volatile=col("ttl_volatile", i32),
        ttl_stable=col("ttl_stable", i32),
        dup_threshold=col("dup_threshold", f32, 0.9999),
        rewrite=col("rewrite", b, False),
        rewrite_rate=col("rewrite_rate", f32, 1.0))


def sweep_grid(base: T.CacheConfig, krites=True, **axes) -> SweepConfig:
    """Cartesian product over ``axes`` (CacheConfig field name -> values),
    every other field taken from ``base``. Row-major: the last axis
    varies fastest, like ``itertools.product``."""
    names = list(axes)
    cfgs = [dataclasses.replace(base, **dict(zip(names, combo)))
            for combo in itertools.product(*(axes[n] for n in names))]
    return sweep_from_configs(cfgs, krites)


def _static_sims(static_emb: torch.Tensor, q_emb: torch.Tensor,
                 chunk: int = 2048):
    """Batched static-tier NN for the whole trace (hoisted lookup): fp32
    ``q @ static_emb.T`` and the first maximum per row, chunk by chunk
    as the reference does. Returns (sims (N,) f32, idx (N,) int64)."""
    n = q_emb.shape[0]
    s = torch.empty((n,), dtype=torch.float32, device=q_emb.device)
    i = torch.empty((n,), dtype=torch.int64, device=q_emb.device)
    for a in range(0, n, chunk):
        torch.max(q_emb[a:a + chunk] @ static_emb.T, dim=1,
                  out=(s[a:a + chunk], i[a:a + chunk]))
    return s, i


def _make_batched_tier(K: int, C: int, d: int, device) -> T.DynamicTier:
    """K per-config dynamic tiers as one batched struct-of-arrays."""
    def z(dtype):
        return torch.zeros((K, C), dtype=dtype, device=device)
    return T.DynamicTier(
        emb=torch.zeros((K, C, d), dtype=torch.float32, device=device),
        cls=z(torch.int32),
        answer_ref=torch.full((K, C), -1, dtype=torch.int32, device=device),
        static_origin=z(torch.bool), valid=z(torch.bool),
        last_used=z(torch.int32), written_at=z(torch.int32),
        expires_at=z(torch.int32))


def _lru_slots(live, last_used, cap) -> torch.Tensor:
    """Batched :func:`tiers._lru_slot`: first non-live row, else LRU,
    restricted to rows [0, cap_k) per config. (K,) int64. ``live`` is
    validity net of per-entry expiry."""
    C = live.shape[1]
    key = torch.where(live, last_used, -T.BIG)
    key = torch.where(torch.arange(C, device=live.device)[None, :]
                      < cap[:, None], key, T.BIG)
    return torch.argmin(key, dim=1)


def _row_write(dyn: T.DynamicTier, ks, slot, cond, q, cls, ref, so,
               now, wa=None, exp=0) -> T.DynamicTier:
    """Conditionally write one tier row per config, in place: row
    ``slot[k]`` of config k takes the new values where ``cond[k]``.

    ``dyn`` carries one spare row past its last (:func:`_scan_core` reads
    the others through views): a config whose ``cond`` is False writes
    the spare row, so the conditional write is one scatter per field.
    ``q`` is (K, d) or (d,); the other values are (K,) or 0-d. ``now``
    stamps the LRU clock; ``wa`` (default ``now``) stamps ``written_at``
    — promotions pass their *enqueue* time so the LWW guard clock
    matches the live policy's while the LRU clock stays the apply time.
    ``exp`` stamps the per-entry expiry clock (0 = never)."""
    slot = torch.where(cond, slot, dyn.valid.shape[1] - 1)
    for arr, new in ((dyn.emb, q), (dyn.cls, cls), (dyn.answer_ref, ref),
                     (dyn.static_origin, so), (dyn.valid, True),
                     (dyn.last_used, now),
                     (dyn.written_at, now if wa is None else wa),
                     (dyn.expires_at, exp)):
        arr[ks, slot] = new
    return dyn


class _Trace(NamedTuple):
    """The trace on the device, and the columns the loop reads as host
    scalars (the step clock indexes them; no device read)."""
    s_static: torch.Tensor   # (N,) f32 hoisted static sims
    h_cls: torch.Tensor      # (N,) i32 class of the static neighbor
    h_idx: torch.Tensor      # (N,) i32 index of the static neighbor
    q_emb: torch.Tensor      # (N, d) f32
    q_cls: torch.Tensor      # (N,) i32
    judge_flip: torch.Tensor  # (N,) bool
    volatile: torch.Tensor   # (N,) bool
    rewritable: torch.Tensor  # (N,) bool
    cls_h: np.ndarray        # host copies of q_cls, volatile, key_id
    vol_h: np.ndarray
    kid_h: np.ndarray


def _zero_state(K, C, d, R, nk, device) -> SimState:
    def zk(dtype=torch.int32):
        return torch.zeros((K,), dtype=dtype, device=device)

    def zn(dtype):
        return torch.zeros((K, nk), dtype=dtype, device=device)
    return SimState(
        dyn=_make_batched_tier(K, C, d, device),
        ring=torch.zeros((K, R), dtype=torch.bool, device=device),
        budget=torch.ones((K,), dtype=torch.float32, device=device), t=0,
        judge_calls=zk(), judge_approved=zk(), promotions=zk(),
        enq_dropped=zk(), l1_exp=zn(torch.int32), l1_w=zn(torch.int32),
        l1_ok=zn(torch.bool), l1_so=zn(torch.bool), ttl_evicted=zk(),
        bypassed=zk(), rbud=zk(torch.float32), rewrites=zk(),
        rewrite_dropped=zk())


def _served_by(l1hit, static_hit, is_rewritten, is_promoted, dyn_hit):
    """Event codes of any shape; ``None`` stands for all False."""
    code = torch.where(dyn_hit, DYN_HIT_DYNAMIC, MISS)
    code = torch.where(is_promoted, DYN_HIT_PROMOTED, code)
    if is_rewritten is not None:
        code = torch.where(is_rewritten, REWRITTEN_HIT, code)
    code = torch.where(static_hit, STATIC_HIT, code)
    if l1hit is not None:
        code = torch.where(l1hit, L1_HIT, code)
    return code.to(torch.int8)


def _outcome(static_hit, dyn_hit, is_promoted, cls_j, qc, hc,
             l1=None):
    """(correct, static_origin) of served requests, any shape: the
    served answer's class against the query's; an L1 hit (``l1`` from
    :func:`_front`) serves what it stored."""
    served_cls = torch.where(static_hit, hc, torch.where(dyn_hit, cls_j, qc))
    correct = served_cls == qc
    static_origin = static_hit | is_promoted
    if l1 is not None:
        l1hit, ok, so, _ = l1
        correct = torch.where(l1hit, ok, correct)
        static_origin = torch.where(l1hit, so, static_origin)
    return correct, static_origin


def _epoch(x, D):
    return torch.div(x, D, rounding_mode="floor")


class _Steps:
    """Per-step (K,) tensors of one window, stacked once at its end: the
    outputs and the counter increments cost no launch inside a step."""

    def __init__(self):
        self.cols: dict[str, list] = {}

    def add(self, **cols) -> None:
        for name, x in cols.items():
            self.cols.setdefault(name, []).append(x)

    def get(self, name):
        xs = self.cols.get(name)
        return None if xs is None else torch.stack(xs)

    def count(self, name):
        return torch.stack(self.cols[name]).sum(0, dtype=torch.int32)


def _flush(steps: _Steps, st: SimState, outs, t0: int, t1: int,
           sh_sem, tr: _Trace) -> None:
    """Write a window's outputs into ``outs`` ((N, K) each) and its
    counter increments into ``st``. ``sh_sem`` is the (N, K) static-hit
    test; a step's static hit is that test unless the front served it.
    Steps of an L1 sweep recorded their own correct/static_origin."""
    g = steps.get
    front = g("front")
    sh = sh_sem[t0:t1] if front is None else sh_sem[t0:t1] & ~front
    dh, pr, l1 = g("dyn_hit"), g("promoted"), g("l1hit")
    if l1 is None:
        correct, so = _outcome(sh, dh, pr, g("cls"),
                               tr.q_cls[t0:t1, None], tr.h_cls[t0:t1, None])
    else:
        correct, so = g("correct"), g("static_origin")
    for o, x in zip(outs, (_served_by(l1, sh, g("rewritten"), pr, dh),
                           correct, so, g("stale"))):
        o[t0:t1] = x
    c = steps.count
    st.judge_calls.add_(c("due"))
    st.judge_approved.add_(c("approve"))
    st.promotions.add_(c("promo"))
    st.enq_dropped.add_(c("want") - c("can"))
    for name, ctr in (("ttl_evicted", st.ttl_evicted),
                      ("bypassed", st.bypassed), ("rw_can", st.rewrites)):
        if name in steps.cols:
            ctr.add_(c(name))
    if "rw_want" in steps.cols:
        st.rewrite_dropped.add_(c("rw_want") - c("rw_can"))


def _outputs(N, K, dev):
    return (torch.empty((N, K), dtype=torch.int8, device=dev),
            *(torch.empty((N, K), dtype=torch.bool, device=dev)
              for _ in range(3)))


def _result(outs, st: SimState) -> SimResult:
    """(N, K) per-step outputs -> the (K, N) config-major SimResult."""
    return SimResult(*(o.T.contiguous() for o in outs),
                     st.judge_calls, st.judge_approved, st.promotions,
                     st.enq_dropped, st.ttl_evicted, st.bypassed,
                     st.rewrites, st.rewrite_dropped)


def _grey(tr: _Trace, sw: SweepConfig):
    """State-independent decision inputs for every step at once: the
    static-hit test and the Krites grey-zone trigger, (N, K) bool."""
    sh_sem = tr.s_static[:, None] >= sw.tau_static[None, :]
    grey = ((tr.s_static[:, None] >= sw.sigma_min[None, :]) & ~sh_sem
            & sw.krites[None, :])
    return sh_sem, grey


def _front(st: SimState, sw: SweepConfig, tr: _Trace, t: int, vol: bool,
           use_l1: bool, use_byp: bool, steps: _Steps, no_k):
    """Freshness front of step t: the volatile bypass, then the L1
    exact-match probe, both decided before the semantic path and with
    no tier traffic. Returns (front, bypass, l1): ``front``/``bypass``
    are None where provably all False; ``l1`` is (hit, stored ok, stored
    static_origin, key column) or None without an L1."""
    byp = sw.volatile_bypass if (use_byp and vol) else None
    front, l1 = byp, None
    if use_l1:
        kid = int(tr.kid_h[t])
        le = st.l1_exp[:, kid]
        hit = sw.l1 & (le > 0) & (t <= le)
        if byp is not None:
            hit &= ~byp
        l1 = (hit, st.l1_ok[:, kid], st.l1_so[:, kid], kid)
        front = hit if byp is None else byp | hit
    if use_l1 or use_byp:
        steps.add(front=no_k if front is None else front,
                  bypassed=no_k if byp is None else byp)
    return front, byp, l1


def _stale(st: SimState, t: int, D: int, static_hit, dyn_hit, wa_j, l1):
    """Drift staleness of a volatile query's serve: content produced in
    an earlier drift epoch (static corpus content is epoch 0)."""
    ep = t // D
    stale = torch.where(static_hit, ep != 0,
                        dyn_hit & (_epoch(wa_j, D) != ep))
    if l1 is not None:
        stale = torch.where(l1[0], _epoch(st.l1_w[:, l1[3]], D) != ep,
                            stale)
    return stale


def _l1_write(st: SimState, sw: SweepConfig, t: int, l1, byp, tau_q,
              static_hit, dyn_hit, wa_j, correct, static_origin) -> None:
    """L1 write-back: every semantic serve lands in the L1 under the
    query's exact key (never refreshed by later hits — the stored
    content clock is what staleness is judged against)."""
    hit, _, _, kid = l1
    do = sw.l1 & ~hit
    if byp is not None:
        do &= ~byp
    content_t = torch.where(static_hit, 0, torch.where(dyn_hit, wa_j, t))
    exp_l1 = (_L1_NEVER if tau_q is None
              else torch.where(tau_q > 0, t + tau_q, _L1_NEVER))
    for col, new in ((st.l1_exp, exp_l1), (st.l1_w, content_t),
                     (st.l1_ok, correct), (st.l1_so, static_origin)):
        col[:, kid] = torch.where(do, new, col[:, kid])


def _scan_core(tr: _Trace, sw: SweepConfig, C: int, R: int, D: int,
               nk: int, use_l1: bool, use_ttl: bool, use_rw: bool,
               use_byp: bool) -> SimResult:
    """All K configs' full-trace loop, one request a step — the general
    path that supports *per-config* judge_latency (uniform sweeps take
    :func:`_scan_core_blocked` instead).

    Each step does one serving lookup (one gemv over the batched tier,
    shared query) and one promotion-dedup lookup (batched per-config
    queries). The tier row promoted this step is excluded from the
    shared pre-write pass and patched back in as one O(d) candidate,
    which reproduces the post-write argmax exactly (lowest-index
    tie-break included).

    Freshness semantics, matching the live policy and the numpy
    reference: per-entry expiry is *lazy* — an entry with
    ``0 < expires_at < t`` is masked from every lookup and becomes an
    immediate LRU reclaim candidate; ``ttl_evicted`` counts each such
    death once, at its first expired step. Volatile bypass serves the
    backend with no cache side effects at all; an L1 hit serves the
    stored answer with no tier traffic; both are decided before the
    semantic path.
    """
    N, d = tr.q_emb.shape
    K = sw.tau_static.shape[0]
    dev = tr.q_emb.device
    ks = torch.arange(K, device=dev)
    iota_c = torch.arange(C, device=dev)[None, :]
    neg_inf = torch.tensor(_NEG_INF, device=dev)
    no_k = torch.zeros((K,), dtype=torch.bool, device=dev)
    lat = torch.clamp(sw.judge_latency, 1, R)
    st = _zero_state(K, C + 1, d, R, nk, dev)
    full = st.dyn                     # row C is _row_write's spare row
    dyn = T.DynamicTier(**{f.name: getattr(full, f.name)[:, :C]
                           for f in dataclasses.fields(full)})
    # values the row writes take, as device tensors (a Python scalar
    # would cost each write a fill)
    clock = torch.arange(N, dtype=torch.int32, device=dev)
    yes, no = torch.tensor(True, device=dev), torch.tensor(False, device=dev)
    none_ref = torch.tensor(-1, dtype=torch.int32, device=dev)
    never = torch.tensor(0, dtype=torch.int32, device=dev)
    ttl_v, ttl_s = sw.ttl_volatile, sw.ttl_stable
    # delayed payload columns, gathered with one index per step
    pay = torch.stack([tr.q_cls, tr.h_cls, tr.h_idx,
                       tr.judge_flip.to(torch.int32),
                       tr.volatile.to(torch.int32),
                       tr.rewritable.to(torch.int32)], 1)
    sh_sem_all, grey_all = _grey(tr, sw)
    outs = _outputs(N, K, dev)
    steps = _Steps()

    for t in range(N):
        q, qc, vol = tr.q_emb[t], int(tr.cls_h[t]), bool(tr.vol_h[t])

        # ---- 0. per-entry expiry: the lazy mask + the once-per-death
        # eviction count (counted before any write can reuse the slot)
        if use_ttl:
            exp = dyn.expires_at
            live = dyn.valid & ((exp == 0) | (t <= exp))
            steps.add(ttl_evicted=(dyn.valid & (exp > 0)
                                   & (exp == t - 1)).sum(1))
        else:
            live = dyn.valid.clone()

        # ---- 1. async completion due now: the task enqueued at
        # t - latency, its payload re-gathered from the trace
        idx_due = t - lat                                      # (K,)
        due = st.ring[ks, torch.remainder(idx_due, R)] & (idx_due >= 0)
        src = torch.clamp(idx_due, min=0)
        p = pay[src]
        p_qc, p_hc, p_hr = p[:, 0], p[:, 1], p[:, 2]
        verdict = (p_qc == p_hc) | (p[:, 3] != 0)
        approve = due & verdict
        if use_rw:
            # REWRITE verdict: a would-reject pair whose ``rewritable``
            # channel is set promotes the tailored variant instead,
            # spending one token of the rewrite bucket
            rbud = st.rbud.add_(sw.rewrite_rate).clamp_(max=1e9)
            rw_want = due & ~verdict & (p[:, 5] != 0) & sw.rewrite
            rw_can = rw_want & (rbud >= 1.0)
            rbud.add_(rw_can, alpha=-1)
            steps.add(rw_want=rw_want, rw_can=rw_can)
            promo = approve | rw_can
        else:
            promo = approve
        steps.add(due=due, approve=approve, promo=promo)

        # ---- tier passes: serving sims (shared query) + promotion-dedup
        # sims (per-config delayed queries), on the pre-write tier
        promo_qk = tr.q_emb[src]                               # (K, d)
        s_serve_raw = (full.emb.reshape(K * (C + 1), d) @ q).reshape(
            K, C + 1)[:, :C]
        s_promo_raw = torch.einsum("kcd,kd->kc", full.emb,
                                   promo_qk)[:, :C]

        # inlined upsert semantics (dedup overwrite + LWW guard) as one
        # conditional K-row write
        s_dup, j_dup = torch.max(torch.where(live, s_promo_raw, neg_inf),
                                 dim=1)
        dup = s_dup >= sw.dup_threshold
        pslot = torch.where(dup, j_dup,
                            _lru_slots(live, dyn.last_used, sw.capacity))
        # LWW guard against the task's enqueue time (idx_due); the
        # promotion records that enqueue time as written_at, while its
        # LRU clock is the apply step t
        stale_w = dup & (dyn.written_at[ks, j_dup] > idx_due)
        do_promote = promo & ~stale_w
        if use_ttl:
            # the verdict's TTL anchors at enqueue time; a verdict that
            # outlived its own TTL is dropped
            tau_p = torch.where(p[:, 4] != 0, ttl_v, ttl_s)
            exp_p = (idx_due + tau_p) * (tau_p > 0)
            do_promote &= ~((exp_p > 0) & (exp_p < t))
        else:
            exp_p = never
        p_cls = torch.where(rw_can, p_qc, p_hc) if use_rw else p_hc
        p_ref = torch.where(rw_can, -2, p_hr) if use_rw else p_hr
        # the shared serving sims are pre-promotion: mask the row just
        # promoted and compare its fresh similarity as one candidate
        promoted_col = do_promote[:, None] & (iota_c == pslot[:, None])
        s0, j0 = torch.max(torch.where(live & ~promoted_col, s_serve_raw,
                                       neg_inf), dim=1)
        _row_write(full, ks, pslot, do_promote, promo_qk, p_cls, p_ref,
                   yes, clock[t], wa=idx_due, exp=exp_p)

        # ---- 1b. freshness front: volatile bypass, then the L1 probe
        front, byp, l1 = _front(st, sw, tr, t, vol, use_l1, use_byp,
                                steps, no_k)

        # ---- 2. serving path (identical for baseline and Krites)
        patch_sim = promo_qk @ q                               # (K,)
        cand = do_promote & ((patch_sim > s0)
                             | ((patch_sim == s0) & (pslot < j0)))
        s_dyn = torch.where(cand, patch_sim, s0)
        j_dyn = torch.where(cand, pslot, j0)

        sh_sem = sh_sem_all[t]
        sd = s_dyn >= sw.tau_dynamic
        static_hit, dyn_hit, miss_wb = sh_sem, ~sh_sem & sd, ~sh_sem & ~sd
        if front is not None:
            static_hit = static_hit & ~front
            dyn_hit &= ~front
            miss_wb &= ~front

        cls_j = dyn.cls[ks, j_dyn]
        is_promoted = dyn_hit & dyn.static_origin[ks, j_dyn]
        steps.add(dyn_hit=dyn_hit, promoted=is_promoted, cls=cls_j)
        if use_rw:
            # rewritten provenance rides the answer_ref = -2 sentinel
            steps.add(rewritten=dyn_hit & (dyn.answer_ref[ks, j_dyn] == -2))
        wa_j = dyn.written_at[ks, j_dyn]
        if use_l1:
            correct, static_origin = _outcome(static_hit, dyn_hit,
                                              is_promoted, cls_j, qc,
                                              tr.h_cls[t], l1)
            steps.add(l1hit=l1[0], correct=correct,
                      static_origin=static_origin)
        steps.add(stale=_stale(st, t, D, static_hit, dyn_hit, wa_j, l1)
                  if D > 0 and vol else no_k)

        # LRU touch on dynamic hit
        full.last_used[ks, torch.where(dyn_hit, j_dyn, C)] = clock[t]
        # baseline write-back on miss (backend answer has the query's
        # class); its lifetime is the query's staleness-risk TTL
        tau_q = (ttl_v if vol else ttl_s) if use_ttl else None
        if use_ttl:
            live2 = dyn.valid & ((dyn.expires_at == 0)
                                 | (t <= dyn.expires_at))
        else:
            live2 = dyn.valid
        _row_write(full, ks, _lru_slots(live2, dyn.last_used, sw.capacity),
                   miss_wb, q, tr.q_cls[t], none_ref, no, clock[t],
                   exp=never if tau_q is None else (t + tau_q) * (tau_q > 0))
        if use_l1:
            _l1_write(st, sw, t, l1, byp, tau_q, static_hit, dyn_hit,
                      wa_j, correct, static_origin)

        # ---- 3. grey-zone trigger (Krites only; off-path). Front-
        # resolved requests never embed, so they can never trigger; a
        # promoted pointer that already serves the query (is_promoted
        # implies s_dyn >= tau_d) skips judging under dedup
        want = grey_all[t] & ~(sw.dedup & is_promoted)
        if front is not None:
            want &= ~front
        budget = st.budget.add_(sw.judge_rate).clamp_(max=1e9)
        can = want & (budget >= 1.0)
        budget.add_(can, alpha=-1)
        # enqueue = set bit (k, t mod R); the slot's previous occupant
        # was consumed at its due step (R >= latency)
        st.ring[:, t % R] = can
        steps.add(want=want, can=can)

        if (t + 1) % _BLOCK == 0 or t == N - 1:
            _flush(steps, st, outs, t + 1 - len(steps.cols["due"]), t + 1,
                   sh_sem_all, tr)
            steps = _Steps()
    return _result(outs, st)


def _scan_core_blocked(tr: _Trace, sw: SweepConfig, C: int, R: int,
                       D: int, nk: int, use_l1: bool, use_ttl: bool,
                       use_rw: bool, use_byp: bool,
                       lat0: int) -> SimResult:
    """Blocked variant of :func:`_scan_core` for the common case where
    every swept config shares one judge_latency ``lat0``.

    The trace is processed in windows of B = _BLOCK requests and the
    tier embeddings are read once per window via two gemms:

      snap = [Q_block ; Q_block_delayed] @ tier_snapshot.T   (2B, K*C)
      QQ   = Qstack @ Qstack.T                               (2B, 2B)

    which is exact because *every row written during a window is a trace
    element*: a miss inserts the current query q_t, a promotion inserts
    the delayed query q_{t-latency}. A per-row registry ``dqi`` records
    which Qstack row overwrote a tier row this window, in three bands:
    [0, B) miss write-backs, [B, 2B) APPROVE promotions, [2B, 3B) REWRITE
    promotions — the rewrite band shares the delayed query's embedding
    (Qstack row ``dqi - B``) but carries the query's class and the
    answer_ref = -2 provenance sentinel. A step's true similarity is
    QQ[s, row of dqi] for window-written rows and snap[s] otherwise, and
    the full-row argmax keeps the exact lowest-index tie-break of the
    sequential simulator. Embeddings are materialized once at window end
    (one masked gather).

    The registry is kept as a column index ``col`` into per-window
    tables that put the bands after the snapshot: row r of config k
    reads column r (its window-start contents), C + dqi once Qstack row
    dqi has written it, or the last column (-inf similarity) while it is
    invalid. A step's similarities are then one gather from
    ``[snap | QQ of each band | -inf]`` and a winning row's class,
    provenance and written_at one gather each. With the LRU clock
    ``key`` (fp32, exact for clocks below 2^24 and the +-BIG sentinels)
    and, with TTLs, ``expw`` (the window-current ``expires_at``), each
    carries a spare column C: a conditional one-row-per-config write is
    one scatter to ``slot`` where the condition holds and to column C
    where it does not.

    The reference pads the last window with inactive steps that change
    no counter; here the last window runs fewer steps. The pending ring
    is a list of R (K,) tensors: slot t mod R holds step t's enqueue bits
    until step t + lat0 reads them.
    """
    N, d = tr.q_emb.shape
    K = sw.tau_static.shape[0]
    B = _BLOCK
    NB = -(-N // B) * B
    dev = tr.q_emb.device
    ks = torch.arange(K, device=dev)
    iota_c = torch.arange(C, device=dev)[None, :]
    spare = torch.tensor(C, device=dev)
    neg_inf = torch.tensor(_NEG_INF, device=dev)
    no_k = torch.zeros((K,), dtype=torch.bool, device=dev)
    st = _zero_state(K, C, d, 1, nk, dev)
    dyn = st.dyn
    ttl_v, ttl_s = sw.ttl_volatile, sw.ttl_stable
    BIG = float(T.BIG)
    i32, f32 = torch.int32, torch.float32

    def pad(x, value=0):
        """R rows in front (the delayed window reads them while nothing
        is due) and up to NB rows at the back."""
        return torch.cat([x.new_full((R, *x.shape[1:]), value), x,
                          x.new_full((NB - N, *x.shape[1:]), value)])

    # front-padded twins so the delayed window t0-lat0 .. t0+B-1-lat0 is
    # a plain slice starting at t0 - lat0 + R >= 0
    q_src, qc_src = pad(tr.q_emb), pad(tr.q_cls)
    hc_src, hr_src = pad(tr.h_cls), pad(tr.h_idx)
    ok_src = pad((tr.q_cls == tr.h_cls) | tr.judge_flip, False)
    rw_src = pad(tr.rewritable, False)
    sh_sem_all, grey_all = _grey(tr, sw)
    nsh_all = ~sh_sem_all
    if use_ttl:
        tau_src = pad(torch.where(tr.volatile[:, None], ttl_v[None, :],
                                  ttl_s[None, :]))               # (., K)
    ring = [no_k] * R
    outs = _outputs(N, K, dev)
    ar = torch.arange(B, device=dev)
    n_bands = 3 if use_rw else 2
    W = C + n_bands * B                  # the -inf column
    # the column a step's miss / APPROVE / REWRITE write gives its row
    band_col = [(C + i * B + ar).unbind(0) for i in range(3)]
    # Qstack row of each band entry (REWRITE shares APPROVE's rows)
    qrow_tab = torch.cat([ar, ar + B] + ([ar + B] if use_rw else []))
    band_so = (torch.arange(n_bands * B, device=dev) >= B)[None, :]
    band_rw = (torch.arange(n_bands * B, device=dev) >= 2 * B)[None, :]

    def table(snap0, bands, last):
        """(K, W + 1): the snapshot's column per row, then the bands'."""
        return torch.cat([snap0, bands.expand(K, -1),
                          snap0.new_full((K, 1), last)], dim=1)

    for t0 in range(0, N, B):
        nsteps = min(B, N - t0)
        c0 = R + t0                          # current window in *_src
        s0 = t0 - lat0 + R                   # delayed window start

        qstack = torch.cat([q_src[c0:c0 + B], q_src[s0:s0 + B]])  # (2B, d)
        snap = (qstack @ dyn.emb.reshape(K * C, d).T).reshape(2 * B, K, C)
        qq = qstack @ qstack.T                                    # (2B, 2B)
        # each step's similarities to every column: [snap | bands | -inf]
        sims_rows = torch.cat(
            [snap, qq[:, qrow_tab][:, None, :].expand(2 * B, K, -1),
             neg_inf.expand(2 * B, K, 1)], dim=2).unbind(0)
        # each band's payload: miss rows carry the query's class and
        # write step; promotion rows the delayed request's static
        # neighbor class (APPROVE) or own class (REWRITE), their enqueue
        # time (lat0 before the apply step) and their answer handle
        tw = (t0 + ar).to(i32)
        band_cls = [qc_src[c0:c0 + B], hc_src[s0:s0 + B]]
        band_wa = [tw, tw - lat0]
        band_ref = [torch.full_like(tw, -1), hr_src[s0:s0 + B]]
        if use_rw:
            band_cls.append(qc_src[s0:s0 + B])
            band_wa.append(tw - lat0)
            band_ref.append(torch.full_like(tw, -2))
        cls_tab, wa_tab = torch.cat(band_cls), torch.cat(band_wa)
        valid0, cls0, so0, wa0 = (dyn.valid, dyn.cls, dyn.static_origin,
                                  dyn.written_at)
        clsx = table(cls0, cls_tab[None, :], 0)
        sox = table(so0, band_so, False)
        wax = table(wa0, wa_tab[None, :], 0)
        rwx = table(dyn.answer_ref == -2, band_rw, False) if use_rw else None

        keyx = torch.empty((K, C + 1), dtype=f32, device=dev)
        keyx[:, :C] = torch.where(
            iota_c < sw.capacity[:, None],
            torch.where(valid0, dyn.last_used.to(f32), -BIG), BIG)
        colx = torch.empty((K, C + 1), dtype=torch.int64, device=dev)
        colx[:, :C] = torch.where(valid0, iota_c, W)
        key, col = keyx[:, :C], colx[:, :C]
        if use_ttl:
            expx = torch.empty((K, C + 1), dtype=i32, device=dev)
            expx[:, :C] = dyn.expires_at
            expw = expx[:, :C]

        def live_of(t):
            valid = col != W
            return valid, valid & ((expw == 0) | (t <= expw))

        def lookup(row, live):
            """(value, first index) of the max over live rows of their
            similarity to Qstack row ``row``."""
            sims = sims_rows[row].gather(1, col)
            if use_ttl:
                sims = torch.where(live, sims, neg_inf)
            return sims.max(dim=1)

        # the window's per-step views, split once
        p_ok = ok_src[s0:s0 + B].unbind(0)
        p_rw = rw_src[s0:s0 + B].unbind(0)
        nsh, grey = nsh_all[t0:t0 + B].unbind(0), grey_all[t0:t0 + B].unbind(0)
        tkey = tw.to(f32).unbind(0)

        steps = _Steps()
        live = None
        for s in range(nsteps):
            t = t0 + s
            vol = bool(tr.vol_h[t])
            if use_ttl:
                valid, live = live_of(t)
                steps.add(ttl_evicted=(valid & (expw > 0)
                                       & (expw == t - 1)).sum(1))

            # ---- 1. async completion due now (= request t - lat0) ----
            idx_due = t - lat0
            due = ring[idx_due % R] if idx_due >= 0 else no_k
            approve = due & p_ok[s]
            if use_rw:
                rbud = st.rbud.add_(sw.rewrite_rate).clamp_(max=1e9)
                rw_want = due & ~p_ok[s] & p_rw[s] & sw.rewrite
                rw_can = rw_want & (rbud >= 1.0)
                rbud.add_(rw_can, alpha=-1)
                steps.add(rw_want=rw_want, rw_can=rw_can)
                promo = approve | rw_can
            else:
                promo = approve
            steps.add(due=due, approve=approve, promo=promo)

            # promotion-dedup lookup (upsert semantics: near-dup
            # overwrite + LWW guard against the enqueue time). The LRU
            # choice is the first minimum of the fp32 key (the
            # reference's argmax(-key)); expired rows are demoted to
            # immediate reclaim (-BIG)
            s_dup, j_dup = lookup(B + s, live)
            key_eff = (torch.where((key < BIG) & ~live, -BIG, key)
                       if use_ttl else key)
            dup = s_dup >= sw.dup_threshold
            pslot = torch.where(dup, j_dup, torch.argmin(key_eff, dim=1))
            wa_dup = wax[ks, col[ks, j_dup]]
            do_promote = promo & ~(dup & (wa_dup > idx_due))
            if use_ttl:
                tau_p = tau_src[s0 + s]
                exp_p = (idx_due + tau_p) * (tau_p > 0)
                do_promote &= ~((exp_p > 0) & (exp_p < t))
            slot = torch.where(do_promote, pslot, spare)
            keyx[ks, slot] = tkey[s]
            colx[ks, slot] = (torch.where(rw_can, band_col[2][s],
                                          band_col[1][s])
                              if use_rw else band_col[1][s])
            if use_ttl:
                expx[ks, slot] = exp_p
                valid, live = live_of(t)

            # ---- 1b. freshness front (bypass + L1 probe) ----
            front, byp, l1 = _front(st, sw, tr, t, vol, use_l1, use_byp,
                                    steps, no_k)

            # ---- 2. serving path (sees this step's promotion: its row's
            # column now points at the band, so it reads QQ, not snap) ----
            s_dyn, j_dyn = lookup(s, live)
            nf = nsh[s] if front is None else nsh[s] & ~front
            dyn_hit = nf & (s_dyn >= sw.tau_dynamic)
            miss = nf ^ dyn_hit

            # winning row's class/provenance: snapshot, or its band's
            c_j = col[ks, j_dyn]
            cls_j = clsx[ks, c_j]
            is_promoted = dyn_hit & sox[ks, c_j]
            steps.add(dyn_hit=dyn_hit, promoted=is_promoted, cls=cls_j)
            if use_rw:
                steps.add(rewritten=dyn_hit & rwx[ks, c_j])
            if use_l1 or (D > 0 and vol):
                static_hit = (sh_sem_all[t] if front is None
                              else sh_sem_all[t] & ~front)
                wa_j = wax[ks, c_j]
            if use_l1:
                correct, static_origin = _outcome(
                    static_hit, dyn_hit, is_promoted, cls_j,
                    int(tr.cls_h[t]), tr.h_cls[t], l1)
                steps.add(l1hit=l1[0], correct=correct,
                          static_origin=static_origin)
            steps.add(stale=_stale(st, t, D, static_hit, dyn_hit, wa_j, l1)
                      if D > 0 and vol else no_k)

            # LRU touch, then write-back on miss (with the query's
            # staleness-risk TTL when the subsystem is on)
            keyx[ks, torch.where(dyn_hit, j_dyn, spare)] = tkey[s]
            if use_ttl:
                tau_q = tau_src[c0 + s]
                key_eff = torch.where((key < BIG) & ~live, -BIG, key)
            else:
                tau_q, key_eff = None, key
            slot = torch.where(miss, torch.argmin(key_eff, dim=1), spare)
            keyx[ks, slot] = tkey[s]
            colx[ks, slot] = band_col[0][s]
            if use_ttl:
                expx[ks, slot] = (t + tau_q) * (tau_q > 0)
            if use_l1:
                _l1_write(st, sw, t, l1, byp, tau_q, static_hit, dyn_hit,
                          wa_j, correct, static_origin)

            # ---- 3. grey-zone trigger (dedup: skip if a promoted
            # pointer already serves this query) ----
            want = grey[s] & ~(sw.dedup & is_promoted)
            if front is not None:
                want &= ~front
            budget = st.budget.add_(sw.judge_rate).clamp_(max=1e9)
            can = want & (budget >= 1.0)
            budget.add_(can, alpha=-1)
            ring[t % R] = can
            steps.add(want=want, can=can)

        _flush(steps, st, outs, t0, t0 + nsteps, sh_sem_all, tr)

        # materialize this window's row writes into the tier
        mask = (col >= C) & (col < W)
        dqi = (col - C).clamp_(0, n_bands * B - 1)
        key_lu = (key > -BIG) & (key < BIG)
        dyn = T.DynamicTier(
            emb=torch.where(mask[:, :, None], qstack[qrow_tab[dqi]],
                            dyn.emb),
            cls=torch.where(mask, cls_tab[dqi], cls0),
            answer_ref=torch.where(mask, torch.cat(band_ref)[dqi],
                                   dyn.answer_ref),
            static_origin=torch.where(mask, dqi >= B, so0),
            valid=dyn.valid | mask,
            # rows neither touched nor written kept their old clock; key
            # holds the new clock for everything else (the sentinels mark
            # untouched invalid rows and rows beyond the capacity)
            last_used=torch.where(key_lu, key.to(i32), dyn.last_used),
            written_at=torch.where(mask, wa_tab[dqi], wa0),
            expires_at=expw.contiguous() if use_ttl else dyn.expires_at)
    return _result(outs, st._replace(dyn=dyn, t=N))


def _run_sweep(tr: _Trace, static_emb, static_cls, sw: SweepConfig,
               C: int, R: int, lat0: int | None, D: int, nk: int,
               use_l1: bool, use_ttl: bool, use_rw: bool,
               use_byp: bool) -> SimResult:
    # the hoisted static lookup is config-independent: computed once,
    # shared across every swept config
    s_static, h_idx = _static_sims(static_emb, tr.q_emb)
    tr = tr._replace(s_static=s_static, h_cls=static_cls[h_idx],
                     h_idx=h_idx.to(torch.int32))
    if lat0 is not None:
        return _scan_core_blocked(tr, sw, C, R, D, nk, use_l1, use_ttl,
                                  use_rw, use_byp, lat0)
    return _scan_core(tr, sw, C, R, D, nk, use_l1, use_ttl, use_rw,
                      use_byp)


def simulate(static_emb, static_cls, q_emb, q_cls, cfg: T.CacheConfig,
             krites: bool, capacity: int | None = None,
             judge_flip=None, volatile=None, key_id=None,
             drift_every: int = 0, rewritable=None,
             device=None) -> SimResult:
    """Run the policy over a request stream on ``device`` (default
    ``cuda``).

    static_emb (S, d) [normalized], static_cls (S,);
    q_emb (N, d) [normalized], q_cls (N,); numpy arrays or tensors.
    judge_flip (N,) bool (optional): requests whose VerifyAndPromote is
    *falsely approved* regardless of class (noisy-verifier study, §5).
    volatile (N,) bool (optional): time-sensitive requests — drives the
    staleness accounting, the bypass, and the TTL class.
    key_id (N,) i32 (required when ``cfg.l1``): exact-duplicate key of
    each request (equal ids = canonically identical prompts).
    drift_every: ground-truth rotation period for volatile queries; a
    hit serving content from an earlier epoch counts as stale.
    rewritable (N,) bool (optional, consulted only when ``cfg.rewrite``):
    would-reject grey-zone requests the rewriter can tailor.

    A single config is a one-row sweep, so it runs the blocked core.
    """
    C = capacity or cfg.capacity
    if capacity is not None:
        cfg = dataclasses.replace(cfg, capacity=capacity)
    res = simulate_sweep(static_emb, static_cls, q_emb, q_cls,
                         sweep_from_configs([cfg], krites),
                         judge_flip=judge_flip, max_capacity=C,
                         volatile=volatile, key_id=key_id,
                         drift_every=drift_every, rewritable=rewritable,
                         device=device)
    return slice_config(res, 0)


def _host(x, dtype) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def simulate_sweep(static_emb, static_cls, q_emb, q_cls,
                   sweep: SweepConfig, judge_flip=None,
                   max_capacity: int | None = None,
                   ring: int | None = None, volatile=None, key_id=None,
                   drift_every: int = 0, rewritable=None,
                   device=None) -> SimResult:
    """Evaluate K configs over one request stream in one pass on
    ``device`` (default ``cuda``).

    Returns a :class:`SimResult` whose every field carries a leading
    (K,) config axis. Per config, results are identical to a
    single-config :func:`simulate` call with the matching
    :class:`tiers.CacheConfig`.

    The dynamic tier is allocated once at ``max_capacity`` (default:
    the largest swept capacity) with per-config capacity masks, and the
    pending ring at ``ring`` slots (default: the largest swept latency).
    The L1 front allocates one column per distinct ``key_id`` (an
    uncapped L1). When every config shares one judge_latency the blocked
    core runs, otherwise the stepwise one, as in the reference.
    """
    dev = get_device(device)
    if torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError("the simulator's decisions need full fp32 "
                           "matmuls; TF32 is enabled")
    sweep = SweepConfig(*(f.cpu() for f in sweep))
    cls_h = _host(q_cls, np.int32)
    N = cls_h.shape[0]
    caps = sweep.capacity.numpy()
    lats = np.clip(sweep.judge_latency.numpy(), 1, None)
    C = int(max_capacity or caps.max())
    R = int(ring or lats.max())
    if caps.max() > C:
        raise ValueError(f"swept capacity {caps.max()} > tier rows {C}")
    if lats.max() > R:
        raise ValueError(f"swept judge_latency {lats.max()} > ring {R}")
    use_l1 = bool(sweep.l1.any())
    if use_l1 and key_id is None:
        raise ValueError("cfg.l1 requires the trace's key_id array "
                         "(exact-duplicate key per request)")
    use_ttl = bool(sweep.ttl_volatile.max() > 0
                   or sweep.ttl_stable.max() > 0)
    use_rw = bool(sweep.rewrite.any())
    zeros = np.zeros((N,), bool)
    vol_h = zeros if volatile is None else _host(volatile, bool)
    kid_h = (np.zeros((N,), np.int32) if key_id is None
             else _host(key_id, np.int32))
    nk = int(kid_h.max(initial=0)) + 1 if use_l1 else 1

    def put(x, dtype):
        return torch.as_tensor(x).to(device=dev, dtype=dtype)
    q_emb = put(q_emb, torch.float32)
    tr = _Trace(s_static=None, h_cls=None, h_idx=None, q_emb=q_emb,
                q_cls=put(cls_h, torch.int32),
                judge_flip=put(zeros if judge_flip is None
                               else _host(judge_flip, bool), torch.bool),
                volatile=put(vol_h, torch.bool),
                rewritable=put(zeros if rewritable is None
                               else _host(rewritable, bool), torch.bool),
                cls_h=cls_h, vol_h=vol_h, kid_h=kid_h)
    sw = SweepConfig(*(f.to(dev) for f in sweep))
    lat0 = int(lats[0]) if (lats == lats[0]).all() else None
    return _run_sweep(tr, put(static_emb, torch.float32),
                      put(static_cls, torch.int32), sw, C=C, R=R,
                      lat0=None if lat0 is None else min(lat0, R),
                      D=int(drift_every), nk=nk, use_l1=use_l1,
                      use_ttl=use_ttl, use_rw=use_rw,
                      use_byp=bool(sweep.volatile_bypass.any()))


# ---------------------------------------------------------------------------
# derived metrics
# ---------------------------------------------------------------------------

def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def summarize(res: SimResult) -> dict:
    """Rates and counters of one config's run. Each rate is an integer
    count times fp32(1 / n), rounded to fp32: the reference's ``jnp.mean``
    of a boolean as XLA evaluates it (the division by the constant n
    becomes a product with its fp32 reciprocal), so a rate sitting on a
    threshold, such as 40 errors in 2,000 requests against a 0.02
    budget, compares as the reference's does."""
    sb, correct, stale = _np(res.served_by), _np(res.correct), \
        _np(res.stale)
    n = sb.shape[0]
    hit = sb != MISS
    # a hit is an error if the served answer is in the wrong equivalence
    # class OR stale (right class, earlier drift epoch)
    bad = hit & (~correct | stale)

    inv_n = np.float32(1) / np.float32(n)

    def rate(mask):
        return float(np.float32(np.count_nonzero(mask)) * inv_n)
    return {
        "requests": n,
        "static_hit_rate": rate(sb == STATIC_HIT),
        "dyn_hit_rate": rate((sb == DYN_HIT_DYNAMIC)
                             | (sb == DYN_HIT_PROMOTED)
                             | (sb == REWRITTEN_HIT)),
        "promoted_hit_rate": rate(sb == DYN_HIT_PROMOTED),
        "rewritten_hit_rate": rate(sb == REWRITTEN_HIT),
        "l1_hit_rate": rate(sb == L1_HIT),
        "total_hit_rate": rate(hit),
        "static_origin_rate": rate(_np(res.static_origin)),
        "error_rate": rate(bad),
        "stale_serve_rate": rate(stale),
        "judge_calls": int(res.judge_calls),
        "judge_approved": int(res.judge_approved),
        "promotions": int(res.promotions),
        "enq_dropped": int(res.enq_dropped),
        "ttl_evictions": int(res.ttl_evicted),
        "bypassed_volatile": int(res.bypassed),
        "rewrites": int(res.rewrites),
        "rewrite_dropped": int(res.rewrite_dropped),
    }


def slice_config(res: SimResult, k: int) -> SimResult:
    """Extract config k's single-config SimResult from a sweep result."""
    return SimResult(*(a[k] for a in res))


def summarize_sweep(res: SimResult) -> list[dict]:
    """Per-config :func:`summarize` rows for a ``simulate_sweep`` result."""
    host = SimResult(*(_np(a) for a in res))   # one device->host copy
    return [summarize(slice_config(host, k))
            for k in range(host.served_by.shape[0])]


def coverage_curve(res: SimResult, n_points: int = 100):
    """Cumulative static-origin served fraction vs requests (Figure 2).

    The cumulative count is an integer, divided in fp32. The sample rows
    are the reference's: its fp32 ``linspace(0, n - 1, n_points)``
    evaluates (under XLA, which folds the two constant factors) to
    ``i * (fp32(1 / div) * fp32(n - 1))``, truncated, with the last
    point ``n - 1``."""
    so = res.static_origin
    n = so.shape[0]
    dev = so.device
    cum = (torch.cumsum(so.to(torch.int64), 0).to(torch.float32)
           / torch.arange(1, n + 1, device=dev, dtype=torch.float32))
    if n_points > 1:
        div = n_points - 1
        step = float(np.float32(np.float32(1) / np.float32(div))
                     * np.float32(n - 1))
        pts = torch.cat([
            torch.arange(div, dtype=torch.float32, device=dev) * step,
            torch.tensor([float(n - 1)], device=dev)])
    else:
        pts = torch.zeros((n_points,), dtype=torch.float32, device=dev)
    pts = pts.to(torch.int32)
    return pts, cum[pts.long()]
