"""Synthetic semantic-cache benchmark traces + the paper's §4.1 protocol
(a numpy copy of ``repro/data/synth_traces.py``: for the same spec it
returns the same arrays; ``tune_threshold`` runs the port's simulator).

The real SemCacheLMArena / SemCacheSearchQueries benchmarks (vCache,
Schroeder et al. 2025) are not downloadable offline, so we reproduce the
*generating process* they encode:

- prompts fall into ground-truth equivalence classes with Zipfian
  popularity;
- class centroids are drawn hierarchically (topics -> classes) so that
  *related-but-not-equivalent* classes have similarity well above random —
  reproducing the vCache "grey zone" where correct/incorrect similarity
  distributions overlap;
- each prompt embedding = normalize(class_centroid + eps * gauss), with
  eps controlling paraphrase spread;
- each prompt has a length attribute so "canonical = shortest prompt in
  class" is meaningful.

Workload presets are calibrated so the tuned baseline lands near the
paper's operating points (static-origin ~8% conversational / ~2% search at
~1-2% error) — see EXPERIMENTS.md §Reproduction for measured values.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np


@dataclass(frozen=True)
class TraceSpec:
    name: str
    n_requests: int
    n_classes: int
    zipf_s: float          # class-popularity exponent
    d: int = 64            # embedding dim
    eps: float = 0.40      # paraphrase noise (intra-class phrasing spread)
    n_topics: int = 64     # hierarchical centroid structure
    topic_spread: float = 0.65  # class scatter around its topic
    min_phrasings: int = 1     # distinct verbatim phrasings per class
    max_phrasings: int = 8
    phrasing_zipf: float = 1.2  # phrasing popularity within a class
    # fraction of classes that are near-duplicates of another class
    # (semantically distinct, textually confusable — the vCache grey-zone
    # error pressure), and how close they sit
    confusable_frac: float = 0.15
    confusable_delta: float = 0.30
    len_lo: int = 12
    len_hi: int = 120
    # freshness-sensitive axis (DESIGN.md §16): a fraction of *classes*
    # is time-sensitive ("what's the price of X now") — their ground
    # truth rotates every drift_every requests, so any cached answer
    # produced in an earlier drift epoch is stale for them. 0 disables.
    volatile_frac: float = 0.0
    drift_every: int = 0
    seed: int = 0


# Conversational (LMArena-like): open-ended prompts, high lexical
# diversity -> many phrasings, wide intra-class spread.
LMARENA_LIKE = TraceSpec(
    name="lmarena_like", n_requests=60_000, n_classes=9_000, zipf_s=0.58,
    eps=0.42, n_topics=48, topic_spread=0.70, min_phrasings=10,
    max_phrasings=16, phrasing_zipf=1.05, confusable_frac=0.30,
    confusable_delta=0.22, seed=17)

# Search (ORCAS-like): short keyword queries, a much longer class tail
# (lower static head coverage), fewer-but-heavier verbatim phrasings.
SEARCH_LIKE = TraceSpec(
    name="search_like", n_requests=150_000, n_classes=52_000, zipf_s=0.80,
    eps=0.52, n_topics=96, topic_spread=0.70, min_phrasings=14,
    max_phrasings=24, phrasing_zipf=0.9, confusable_frac=0.35,
    confusable_delta=0.17, seed=29)

WORKLOADS = {w.name: w for w in (LMARENA_LIKE, SEARCH_LIKE)}


def _normalize(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-9)


def generate_trace(spec: TraceSpec) -> Dict[str, np.ndarray]:
    """Returns {emb (N,d) fp32 normalized, cls (N,) i32, length (N,) i32,
    key (N,) i32, volatile (N,) bool}.

    Requests are *verbatim phrasings*: each class owns a small pool of
    distinct phrasing embeddings (centroid + eps*gauss) and a request
    samples one, so exact repeats and paraphrases coexist — like real
    query logs (and like the vCache benchmarks, which contain both).
    ``key`` is the dense exact-duplicate id (equal keys = identical
    phrasing = identical prompt text — the L1 front's canonical key);
    ``volatile`` marks requests whose class is time-sensitive
    (``volatile_frac`` of classes, ground truth rotating every
    ``drift_every`` requests).
    """
    rng = np.random.default_rng(spec.seed)
    rootd = np.sqrt(spec.d)   # noise norms are relative to the unit sphere

    topics = _normalize(rng.standard_normal((spec.n_topics, spec.d)))
    topic_of_cls = rng.integers(0, spec.n_topics, spec.n_classes)
    centroids = _normalize(
        topics[topic_of_cls]
        + spec.topic_spread / rootd
        * rng.standard_normal((spec.n_classes, spec.d)))

    # confusable near-duplicate classes: distinct intent, close embedding
    n_conf = int(spec.confusable_frac * spec.n_classes)
    if n_conf:
        dup = rng.choice(spec.n_classes, n_conf, replace=False)
        src = rng.integers(0, spec.n_classes, n_conf)
        delta = spec.confusable_delta * (0.75 + 0.5 * rng.random(n_conf))
        centroids[dup] = _normalize(
            centroids[src] + delta[:, None] / rootd
            * rng.standard_normal((n_conf, spec.d)))

    # per-class phrasing pool (lazily materialized per request for memory)
    n_phr = rng.integers(spec.min_phrasings, spec.max_phrasings + 1,
                         spec.n_classes)

    # Zipf popularity over a random permutation of class ids
    ranks = np.arange(1, spec.n_classes + 1, dtype=np.float64)
    probs = ranks ** -spec.zipf_s
    probs /= probs.sum()
    perm = rng.permutation(spec.n_classes)
    cls = perm[rng.choice(spec.n_classes, size=spec.n_requests, p=probs)]

    # phrasing index per request: Zipf within the class's pool
    u = rng.random(spec.n_requests)
    kc = n_phr[cls].astype(np.float64)
    pr = np.floor(kc * u ** spec.phrasing_zipf).astype(np.int64)
    pr = np.minimum(pr, n_phr[cls] - 1)

    # deterministic phrasing embedding: seed from (class, phrasing)
    base = rng.integers(0, 2**31)
    noise = _phrasing_noise(base, cls, pr, spec.d)
    emb = _normalize(centroids[cls] + (spec.eps / rootd) * noise)

    # deterministic phrasing length: same phrasing -> same length
    length = ((cls * 2654435761 + pr * 40503 + base) %
              (spec.len_hi - spec.len_lo)) + spec.len_lo

    # dense exact-duplicate key: one id per distinct (class, phrasing) —
    # the same identity the L1 front's canonicalization induces on text
    pair = (cls.astype(np.int64) << 20) ^ pr.astype(np.int64)
    _, key = np.unique(pair, return_inverse=True)

    # time-sensitive classes: a fixed fraction, drawn after the trace so
    # the embedding stream is bit-identical whether or not the
    # freshness axis is on
    vol_cls = np.zeros(spec.n_classes, bool)
    n_vol = int(round(spec.volatile_frac * spec.n_classes))
    if n_vol:
        vol_cls[rng.choice(spec.n_classes, n_vol, replace=False)] = True
    return {"emb": emb.astype(np.float32), "cls": cls.astype(np.int32),
            "length": length.astype(np.int32),
            "key": key.astype(np.int32), "volatile": vol_cls[cls]}


def _phrasing_noise(base: int, cls: np.ndarray, phr: np.ndarray,
                    d: int) -> np.ndarray:
    """Deterministic per-(class, phrasing) gaussian noise — identical
    phrasings get identical embeddings without materializing every pool."""
    key = (cls.astype(np.int64) << 20) ^ phr.astype(np.int64) ^ base
    uniq, inv = np.unique(key, return_inverse=True)
    rngs = np.random.default_rng(abs(base) + 7)
    # one RNG stream, rows indexed by rank of the unique key
    block = rngs.standard_normal((len(uniq), d))
    return block[inv]


# ---------------------------------------------------------------------------
# §4.1 protocol: history/eval split + coverage-based static construction
# ---------------------------------------------------------------------------

@dataclass
class Benchmark:
    static_emb: np.ndarray   # (S, d) canonical prompt embeddings
    static_cls: np.ndarray   # (S,)
    eval_emb: np.ndarray     # (N_eval, d)
    eval_cls: np.ndarray     # (N_eval,)
    spec: TraceSpec
    n_history: int
    eval_key: np.ndarray | None = None       # (N_eval,) exact-dup ids
    eval_volatile: np.ndarray | None = None  # (N_eval,) time-sensitive


def build_benchmark(spec: TraceSpec, history_frac: float = 0.2,
                    coverage: float = 0.6) -> Benchmark:
    """History prefix -> popularity -> head classes covering ``coverage`` of
    history requests -> one canonical (shortest) representative each.

    The trace from :func:`generate_trace` is already in deterministic
    shuffled order (fixed seed), matching the paper's setup.
    """
    trace = generate_trace(spec)
    n_hist = int(spec.n_requests * history_frac)
    h_cls = trace["cls"][:n_hist]
    h_len = trace["length"][:n_hist]
    h_emb = trace["emb"][:n_hist]

    classes, counts = np.unique(h_cls, return_counts=True)
    order = np.argsort(-counts, kind="stable")
    cum = np.cumsum(counts[order]) / n_hist
    take = int(np.searchsorted(cum, coverage) + 1)
    head = classes[order[:take]]

    # canonical = shortest prompt of the class within history
    static_emb, static_cls = [], []
    head_set = set(head.tolist())
    best: Dict[int, int] = {}
    for i in range(n_hist):
        c = int(h_cls[i])
        if c in head_set and (c not in best or h_len[i] < h_len[best[c]]):
            best[c] = i
    for c, i in sorted(best.items()):
        static_emb.append(h_emb[i])
        static_cls.append(c)

    return Benchmark(
        static_emb=np.stack(static_emb).astype(np.float32),
        static_cls=np.asarray(static_cls, np.int32),
        eval_emb=trace["emb"][n_hist:],
        eval_cls=trace["cls"][n_hist:],
        spec=spec,
        n_history=n_hist,
        eval_key=trace["key"][n_hist:],
        eval_volatile=trace["volatile"][n_hist:],
    )


def tune_threshold(bench: Benchmark, error_budget: float = 0.02,
                   grid=None, sample: int = 20_000,
                   capacity: int = 4096, device=None) -> float:
    """Tune the single baseline threshold t* (paper §4.2): choose the
    lowest threshold whose baseline error rate stays within the budget
    (Pareto point at ~1-2%% error), on a prefix sample of the eval stream.

    The whole grid runs as ONE ``simulate_sweep`` on ``device`` (default
    ``cuda``); the selection rule is the reference's — lowest threshold
    among those within budget that maximizes total hit rate.
    """
    from repro_torch.core.simulate import (simulate_sweep, summarize_sweep,
                                           sweep_from_configs)
    from repro_torch.core.tiers import CacheConfig

    if grid is None:
        grid = np.arange(0.70, 0.97, 0.02)
    cfgs = [CacheConfig(tau_static=float(t), tau_dynamic=float(t),
                        capacity=capacity) for t in grid]
    res = simulate_sweep(bench.static_emb, bench.static_cls,
                         bench.eval_emb[:sample], bench.eval_cls[:sample],
                         sweep_from_configs(cfgs, krites=False),
                         device=device)
    best_t, best_hit = float(grid[-1]), -1.0
    for t, row in zip(grid, summarize_sweep(res)):
        if row["error_rate"] <= error_budget \
                and row["total_hit_rate"] > best_hit:
            best_hit = row["total_hit_rate"]
            best_t = float(t)
    return best_t
