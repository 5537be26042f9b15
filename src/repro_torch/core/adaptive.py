"""Online per-segment threshold adaptation via shadow sweeps
(DESIGN.md §17).

A copy of the reference's ``repro/core/adaptive.py``; its shadow sweep
runs the port's ``core/simulate.simulate_sweep`` on the policy's
device.

Thresholds are tuned offline (``scripts/calibrate.py``) and pinned for
the lifetime of the service — exactly the operating-point rigidity the
follow-up papers (PAPERS.md: "From Offline Learning to Online
Adaptation", "Continuous Semantic Caching") show costs hit rate the
moment the traffic distribution moves. This module closes the loop:

- **Segments.** Traffic is keyed by the freshness classifier's
  canonical-token machinery (``core/freshness.classify`` over
  ``canonicalize`` token streams): UNKNOWN / VOLATILE / STABLE each get
  their own live ``(tau_static, tau_dynamic)`` operating point. The
  policies read these per request — one source of truth under
  ``dyn_lock`` across the scalar, batched, fused and mesh serve paths.

- **Window.** A bounded ring buffer records every semantically-served
  request (embedding, outcome label, segment). Labels start as the
  request's class id (``meta['cls']``, falling back to the static
  neighbor's class) and are *rewritten by evidence*: an async judge
  verdict stamps the neighbor class on approve or a unique reject
  sentinel on reject, and operator error feedback
  (``CacheRouter.feedback``) does the same — so the shadow evaluator
  scores candidate thresholds against what the service has actually
  learned about its traffic, not just the prior labels.

- **Shadow sweep.** Every ``adapt_every`` recorded requests (once the
  window is full), the controller re-scores a candidate threshold grid
  centered on each active segment's live point against the whole
  window in ONE ``simulate_sweep`` dispatch (the batched-K evaluator of
  DESIGN.md §10; all segments' grids ride the same dispatch and
  per-segment metrics are masked out of the shared (K, N) decision
  streams). Selection walks the measured Pareto frontier: the
  feasible-set rule of ``tune_threshold`` (max hits subject to the
  error budget) plus epsilon-greedy exploration over the feasible set,
  a bounded step size, and hysteresis so the critical path never flaps.

- **Determinism.** No wall clock, no entropy: exploration comes from a
  seeded 64-bit LCG advanced once per adaptation, and all metric
  arithmetic is integer counts + python-float threshold math, so the
  pure-numpy reference twin (``tests/ref_policy.ref_adaptive``) pins
  every adaptive decision field-identically.

The controller itself is policy-agnostic: it never imports the policy
and takes the lock + static tier handles as arguments, so the live
``BaselinePolicy``/``KritesPolicy`` and the test harnesses share it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.freshness import STABLE, VOLATILE, classify

SEGMENT_NAMES = ("unknown", "volatile", "stable")
N_SEGMENTS = 3

_LCG_MUL = 6364136223846793005
_LCG_INC = 1442695040888963407
_LCG_MASK = (1 << 64) - 1


def segment_of(text: str) -> int:
    """Traffic segment of a prompt: the freshness classifier's
    staleness-risk class over canonical tokens (0=unknown, 1=volatile,
    2=stable). Pure — safe to call outside any lock."""
    c = classify(text)
    if c == VOLATILE:
        return 1
    if c == STABLE:
        return 2
    return 0


def lcg_next(state: int) -> int:
    """One step of the 64-bit LCG driving epsilon-greedy exploration.
    Deterministic and shared with the numpy reference twin."""
    return (state * _LCG_MUL + _LCG_INC) & _LCG_MASK


@dataclass(frozen=True)
class AdaptiveParams:
    """Controller knobs. Defaults are conservative: small grids, small
    bounded steps, explore off — enable ``epsilon`` to trade a little
    window-local optimality for drift robustness."""
    window: int = 1024        # request-window ring size (W)
    adapt_every: int = 256    # recorded requests between shadow sweeps
    grid_points: int = 3      # candidates per threshold axis (odd:
    #                           the live point sits at the grid center)
    grid_radius: float = 0.04  # candidate spread around the live point
    max_step: float = 0.02    # bounded nudge per adaptation
    hysteresis: float = 0.005  # min hit-rate gain (fraction of the
    #                            segment window) required to move
    error_budget: float = 0.02  # shadow error ceiling (tune_threshold's)
    epsilon: float = 0.0      # explore probability over the feasible set
    tau_lo: float = 0.55      # hard floor for any live threshold
    tau_hi: float = 0.99      # hard ceiling (< dup_threshold by design)
    min_segment: int = 64     # window rows a segment needs to adapt
    shadow_capacity: int = 256  # dynamic-tier rows in the shadow sim
    seed: int = 0x9E3779B9    # LCG init for epsilon-greedy

    def __post_init__(self):
        if self.grid_points < 1 or self.grid_points % 2 == 0:
            raise ValueError("grid_points must be odd (live point at "
                             f"the grid center), got {self.grid_points}")
        if not (0.0 < self.tau_lo < self.tau_hi <= 1.0):
            raise ValueError(f"bad bounds [{self.tau_lo}, {self.tau_hi}]")


def candidate_grid(center_s: float, center_d: float,
                   p: AdaptiveParams) -> Tuple[list, int]:
    """The candidate (tau_static, tau_dynamic) grid around one live
    operating point: the cross product of ``grid_points`` evenly spaced
    values per axis, clipped to [tau_lo, tau_hi]. Returns the candidate
    list and the index of the live point (always present: odd
    ``grid_points`` puts it at both axis centers)."""
    g = p.grid_points
    half = g // 2
    step = p.grid_radius / max(half, 1)

    def axis(center):
        vals = []
        for k in range(g):
            v = center + (k - half) * step
            vals.append(min(max(v, p.tau_lo), p.tau_hi))
        vals[half] = center        # clipping must never move the center
        return vals

    ts_vals, td_vals = axis(center_s), axis(center_d)
    cands = [(ts, td) for ts in ts_vals for td in td_vals]
    return cands, half * g + half


def choose_candidate(hits: Sequence[int], errs: Sequence[int],
                     n_seg: int, center: int, p: AdaptiveParams,
                     explore_pick: Optional[int]) -> Tuple[int, str]:
    """Pareto-frontier selection over one segment's candidate grid.

    Pure integer/float arithmetic shared with the numpy reference twin:
    feasible = within the error budget; greedy = max hits (ties: fewer
    errors, then lowest index — i.e. closest to the frontier in grid
    order); hysteresis holds the live point unless the greedy winner
    beats it by ``hysteresis * n_seg`` hits (or the live point itself
    is infeasible); ``explore_pick`` (a pre-drawn LCG value, None = no
    exploration this round) indexes uniformly into the feasible set.

    Returns ``(chosen index, reason)`` with reason one of
    'hold' | 'greedy' | 'repair' | 'explore'.
    """
    K = len(hits)
    feasible = [k for k in range(K)
                if errs[k] <= p.error_budget * n_seg]
    if explore_pick is not None and feasible:
        return feasible[explore_pick % len(feasible)], "explore"
    if not feasible:
        # nothing within budget: repair toward minimum error
        best = min(range(K), key=lambda k: (errs[k], -hits[k], k))
        return (best, "repair") if best != center else (center, "hold")
    best = min(feasible, key=lambda k: (-hits[k], errs[k], k))
    if center in feasible:
        if hits[best] <= hits[center] + p.hysteresis * n_seg:
            return center, "hold"
    return (best, "greedy") if best != center else (center, "hold")


def _default_shadow_eval(static_emb, static_cls, q_emb, q_cls, cfgs):
    """One ``simulate_sweep`` dispatch over all candidate configs, on
    the device of ``static_emb`` (the policy's static tier, or its first
    shard's under a mesh); returns
    host (K, N) decision streams. Baseline (krites=False) semantics:
    the shadow scores *serving thresholds* against the window — the
    async promotion pipeline's effect on the frontier is second-order
    at window scale and would cost a judge model the shadow does not
    have."""
    import torch

    from repro_torch.core.simulate import simulate_sweep, sweep_from_configs

    if isinstance(static_emb, (tuple, list)):   # a sharded tier's blocks
        dev = static_emb[0].device
    else:
        dev = static_emb.device if isinstance(static_emb, torch.Tensor) \
            else None
    res = simulate_sweep(static_emb, static_cls, q_emb, q_cls,
                         sweep_from_configs(cfgs, krites=False),
                         device=dev)
    return res.served_by.cpu().numpy(), res.correct.cpu().numpy()


class AdaptiveController:
    """Live per-segment threshold state + the shadow-sweep adaptation
    loop. All mutable state is guarded by the *policy's* ``dyn_lock``
    (the controller never takes it itself except in
    :meth:`maybe_adapt`, which is documented lock-free on entry), so
    threshold reads, window records and verdict rewrites are consistent
    with the tier mutations they ride along with."""

    def __init__(self, cfg, d: int,
                 params: Optional[AdaptiveParams] = None,
                 shadow_eval: Optional[Callable] = None,
                 frozen: bool = False):
        p = self.params = params or AdaptiveParams()
        self.d = int(d)
        self.cfg = cfg
        self.frozen = bool(frozen)
        self.shadow_eval = shadow_eval or _default_shadow_eval
        # live operating points, one per segment, seeded at the pinned
        # config — adaptive-off (frozen) serving is bit-identical to a
        # pinned policy because these never move
        self.tau_static: List[float] = \
            [float(cfg.tau_static)] * N_SEGMENTS
        self.tau_dynamic: List[float] = \
            [float(cfg.tau_dynamic)] * N_SEGMENTS
        # bounded request window (ring): embedding, evidence label,
        # segment. seq is 1-based and monotonic; row seq s lives at
        # (s - 1) % window until overwritten W records later.
        self._w_emb = np.zeros((p.window, self.d), np.float32)
        self._w_label = np.zeros(p.window, np.int32)
        self._w_seg = np.zeros(p.window, np.int8)
        self._count = 0           # total records ever (== last seq)
        self._since = 0           # records since the last adaptation
        # regret-style counters (per segment): shadow hits the live
        # point left on the table vs the measured frontier, summed over
        # sweeps; plus controller activity counters
        self.regret: List[int] = [0] * N_SEGMENTS
        self.seen: List[int] = [0] * N_SEGMENTS
        self.adaptations = 0
        self.moves = 0
        self.explores = 0
        self.verdicts = 0
        self.feedbacks = 0
        self._rng = lcg_next(p.seed & _LCG_MASK)
        self._last: dict = {}     # most recent sweep, for stats

    # -- critical-path reads (caller holds dyn_lock) ----------------------

    def thresholds(self, seg: int) -> Tuple[float, float]:
        return self.tau_static[seg], self.tau_dynamic[seg]

    # -- window recording (caller holds dyn_lock) -------------------------

    def record(self, emb: np.ndarray, label: int, seg: int) -> int:
        """Append one served request to the window; returns its seq
        (stamped into ``ServeResult.meta['adapt_seq']`` so judge
        verdicts and operator feedback can find the row again)."""
        i = self._count % self.params.window
        self._w_emb[i] = emb
        self._w_label[i] = label
        self._w_seg[i] = seg
        self._count += 1
        self._since += 1
        self.seen[seg] += 1
        return self._count

    def _row_of(self, seq: int) -> Optional[int]:
        """Ring row still holding ``seq``, or None if overwritten."""
        if seq is None or seq <= 0 or seq > self._count \
                or seq <= self._count - self.params.window:
            return None
        return (seq - 1) % self.params.window

    def record_verdict(self, seq: int, approved: bool,
                       h_cls: int) -> None:
        """Judge-verdict evidence: the async judge decided whether this
        window row's query really belongs to its static neighbor's
        class. Approve stamps the neighbor class; reject stamps a
        unique negative sentinel (−2−seq) so the shadow counts any
        static/neighbor serve of that row as an error without aliasing
        two rejected rows onto each other."""
        i = self._row_of(seq)
        if i is None:
            return
        self.verdicts += 1
        self._w_label[i] = int(h_cls) if approved else -2 - int(seq)

    def record_feedback(self, seq: int, ok: bool) -> None:
        """Operator error feedback on a served answer (router-level):
        a report of a wrong answer poisons the row's label with the
        same unique reject sentinel the judge path uses."""
        i = self._row_of(seq)
        if i is None:
            return
        self.feedbacks += 1
        if not ok:
            self._w_label[i] = -2 - int(seq)

    # -- adaptation -------------------------------------------------------

    def should_adapt(self) -> bool:
        """Caller holds dyn_lock. Adapts only on a *full* window (fixed
        shadow trace length keeps the sweep's compiled program stable
        across the service lifetime) and at the configured cadence."""
        return (not self.frozen
                and self._count >= self.params.window
                and self._since >= self.params.adapt_every)

    def window_snapshot(self):
        """Window in insertion order, oldest first (caller holds
        dyn_lock). Only valid once the ring is full."""
        W = self.params.window
        pos = self._count % W
        order = np.concatenate([np.arange(pos, W), np.arange(0, pos)])
        return (self._w_emb[order].copy(), self._w_label[order].copy(),
                self._w_seg[order].copy())

    def maybe_adapt(self, lock, static_emb, static_cls) -> bool:
        """The adaptation step: snapshot the window under ``lock``, run
        the shadow sweep *outside* it (device work must not stall the
        serve path), then install the nudged operating points back
        under ``lock``. Returns True when a sweep ran."""
        with lock:
            if not self.should_adapt():
                return False
            self._since = 0
            emb, label, seg = self.window_snapshot()
            centers = [(self.tau_static[s], self.tau_dynamic[s])
                       for s in range(N_SEGMENTS)]
            rng = self._rng = lcg_next(self._rng)
        plan, last = self._plan(emb, label, seg, centers, rng,
                                static_emb, static_cls)
        with lock:
            self.adaptations += 1
            self._last = last
            for s, (ts, td, reason, gap) in plan.items():
                self.regret[s] += gap
                if reason == "explore":
                    self.explores += 1
                if (ts, td) != (self.tau_static[s], self.tau_dynamic[s]):
                    self.moves += 1
                    self.tau_static[s], self.tau_dynamic[s] = ts, td
        return True

    def _plan(self, emb, label, seg, centers, rng, static_emb,
              static_cls):
        """One shadow sweep over the window -> per-segment nudges.
        Pure w.r.t. controller state (everything it needs came in as
        arguments), so the numpy reference twin can replay it."""
        p = self.params
        active = [s for s in range(N_SEGMENTS)
                  if int((seg == s).sum()) >= p.min_segment]
        if not active:
            return {}, {"active": []}

        cfgs, spans = [], {}     # seg -> (start, cands, center_idx)
        for s in active:
            cands, ci = candidate_grid(*centers[s], p)
            spans[s] = (len(cfgs), cands, ci)
            cfgs.extend(self._shadow_cfg(ts, td) for ts, td in cands)

        served_by, correct = self.shadow_eval(
            static_emb, static_cls, emb, label, cfgs)
        hit = np.asarray(served_by) != 0          # MISS == 0
        bad = hit & ~np.asarray(correct)

        # epsilon-greedy: one explore decision per sweep, applied to
        # every active segment, each with its own derived pick
        explore = (rng >> 17) % 1_000_000 < int(p.epsilon * 1_000_000)

        plan, last = {}, {"active": active, "segments": {}}
        for s in active:
            start, cands, ci = spans[s]
            mask = seg == s
            n_seg = int(mask.sum())
            hits = [int((hit[start + k] & mask).sum())
                    for k in range(len(cands))]
            errs = [int((bad[start + k] & mask).sum())
                    for k in range(len(cands))]
            pick = (lcg_next(rng + s) >> 11) if explore else None
            k, reason = choose_candidate(hits, errs, n_seg, ci, p, pick)
            # regret vs the measured frontier (greedy winner), even
            # when exploring or holding
            g, _ = choose_candidate(hits, errs, n_seg, ci, p, None)
            gap = max(0, hits[g] - hits[ci])
            cs, cd = centers[s]
            ts = cs + min(max(cands[k][0] - cs, -p.max_step), p.max_step)
            td = cd + min(max(cands[k][1] - cd, -p.max_step), p.max_step)
            ts = min(max(ts, p.tau_lo), p.tau_hi)
            td = min(max(td, p.tau_lo), p.tau_hi)
            plan[s] = (ts, td, reason, gap)
            last["segments"][SEGMENT_NAMES[s]] = {
                "n": n_seg, "chosen": k, "reason": reason,
                "center_hits": hits[ci], "center_errs": errs[ci],
                "best_hits": hits[g], "best_errs": errs[g],
                "tau_static": ts, "tau_dynamic": td,
            }
        return plan, last

    def _shadow_cfg(self, ts: float, td: float):
        """A candidate CacheConfig for the shadow sweep: the live
        serving thresholds under test, the shadow tier capacity, and
        dup_threshold pinned to 1.0 (the shadow is baseline-only — no
        promotions — and 1.0 satisfies the >= tau_dynamic validation
        for any candidate)."""
        from repro_torch.core.tiers import CacheConfig
        return CacheConfig(tau_static=ts, tau_dynamic=td,
                           sigma_min=0.0,
                           capacity=self.params.shadow_capacity,
                           judge_latency=1, dup_threshold=1.0)

    # -- telemetry / persistence ------------------------------------------

    def stats(self) -> dict:
        """Live operating points + regret counters for router/stats
        windows. Caller need not hold the lock for a monitoring read —
        python float/int reads are atomic and monotonic-ish staleness
        is fine for dashboards."""
        out = {
            "adaptive_frozen": self.frozen,
            "adaptive_window_fill": min(self._count, self.params.window),
            "adaptive_adaptations": self.adaptations,
            "adaptive_moves": self.moves,
            "adaptive_explores": self.explores,
            "adaptive_verdicts": self.verdicts,
            "adaptive_feedbacks": self.feedbacks,
        }
        for s, name in enumerate(SEGMENT_NAMES):
            out[f"tau_static_{name}"] = self.tau_static[s]
            out[f"tau_dynamic_{name}"] = self.tau_dynamic[s]
            out[f"adaptive_regret_{name}"] = self.regret[s]
            out[f"adaptive_seen_{name}"] = self.seen[s]
        return out

    def to_state(self) -> Tuple[dict, dict]:
        """(arrays, scalars) for snapshot persistence (DESIGN.md §14:
        arrays ride the hashed leaf tree, scalars the JSON manifest).
        Caller holds dyn_lock."""
        arrays = {
            "emb": self._w_emb.copy(),
            "label": self._w_label.copy(),
            "seg": self._w_seg.copy(),
            "tau_static": np.asarray(self.tau_static, np.float64),
            "tau_dynamic": np.asarray(self.tau_dynamic, np.float64),
        }
        scalars = {
            "window": int(self.params.window),
            "count": int(self._count), "since": int(self._since),
            "adaptations": int(self.adaptations),
            "moves": int(self.moves), "explores": int(self.explores),
            "verdicts": int(self.verdicts),
            "feedbacks": int(self.feedbacks),
            "regret": [int(r) for r in self.regret],
            "seen": [int(s) for s in self.seen],
            "rng": int(self._rng), "frozen": bool(self.frozen),
        }
        return arrays, scalars

    def load_state(self, arrays: dict, scalars: dict) -> None:
        """Restore a snapshot's controller state (caller holds
        dyn_lock). The window geometry must match — a resized window
        cannot meaningfully inherit ring contents."""
        if int(scalars["window"]) != self.params.window:
            raise ValueError(
                f"snapshot window {scalars['window']} != controller "
                f"window {self.params.window}")
        self._w_emb[:] = arrays["emb"]
        self._w_label[:] = arrays["label"]
        self._w_seg[:] = arrays["seg"]
        self.tau_static = [float(x) for x in arrays["tau_static"]]
        self.tau_dynamic = [float(x) for x in arrays["tau_dynamic"]]
        self._count = int(scalars["count"])
        self._since = int(scalars["since"])
        self.adaptations = int(scalars["adaptations"])
        self.moves = int(scalars["moves"])
        self.explores = int(scalars["explores"])
        self.verdicts = int(scalars.get("verdicts", 0))
        self.feedbacks = int(scalars.get("feedbacks", 0))
        self.regret = [int(r) for r in scalars["regret"]]
        self.seen = [int(s) for s in scalars["seen"]]
        self._rng = int(scalars["rng"])
        self.frozen = bool(scalars["frozen"])
