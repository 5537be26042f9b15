"""The port's trace simulator (``repro_torch.core.simulate``) on the CPU
against the numpy oracle ``ref_policy.ref_simulate`` and the JAX
simulator, field by field.

The exact tests run on a *dyadic* trace: every embedding is rounded to a
multiple of 2^-8, so every dot product at d = 64, and every partial sum
of one, is a multiple of 2^-16 of magnitude about 1 and exact in fp32
whatever the summation order (gemm or gemv, XLA, numpy or torch, with
or without FMA). A sequential simulator turns one flipped comparison
into a different tier state for every later request, so on such a trace
the port must agree with both references on every request and counter.
One float trace is held to the parity contract's near-threshold rule.

Every config runs through ``simulate`` (the blocked core) and through
mixed-latency sweeps (the stepwise core) against ``ref_simulate``; the
JAX simulator is compiled for six ``simulate_sweep`` programs, each run
once and shared through the ``jax_runs`` fixture:

1. ``plain-blocked``: the plain configs at one latency (blocked core);
2. ``plain-step``: the plain configs with judge flips (stepwise core);
3. ``fresh-blocked``: L1 + TTL + volatile bypass + drift at one latency;
4. ``fresh-step``: the same configs at their mixed latencies;
5. ``rw-blocked``: rewrite configs (three-band dqi) at one latency;
6. ``rw-step``: the same configs at their mixed latencies.

``test_jax_compile_budget`` checks that the file compiles no more.
JAX's ``summarize`` and ``coverage_curve`` run op by op on the host.
No hypothesis, no ``jax.jit`` of its own; one thread.
"""
import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ref_policy import ref_simulate

from repro.core.tiers import CacheConfig as JCacheConfig
from repro.data.synth_traces import LMARENA_LIKE, build_benchmark
from repro_torch.core import simulate as tsim
from repro_torch.core.tiers import CacheConfig

# the package re-exports the function ``simulate`` under the module's name
jsim = importlib.import_module("repro.core.simulate")
torch.set_num_threads(1)

N_REQ = 2000
DRIFT = 128
NEAR = 1e-5        # the parity contract's near-threshold band
RATE_TOL = 1e-6    # summary rates: integer counts / n against JAX's f32 mean

# the differential configs of tests/test_ref_differential.py, plus a
# judge_rate 0.3 config with dedup off and an odd capacity and latency
PLAIN = [
    (CacheConfig(0.90, 0.90, sigma_min=0.0, capacity=128,
                 judge_latency=8), True),
    (CacheConfig(0.86, 0.90, sigma_min=0.5, capacity=64,
                 judge_latency=32, judge_rate=0.25), True),
    (CacheConfig(0.94, 0.88, sigma_min=0.7, capacity=256,
                 judge_latency=1), True),
    (CacheConfig(0.90, 0.90, sigma_min=0.0, capacity=128,
                 judge_latency=8), False),
    (CacheConfig(0.88, 0.90, sigma_min=0.3, capacity=96,
                 judge_latency=12, judge_rate=0.3, dedup=False), True),
]
FRESH = [
    (CacheConfig(0.90, 0.90, sigma_min=0.0, capacity=128,
                 judge_latency=8, l1=True), True),
    (CacheConfig(0.90, 0.90, sigma_min=0.5, capacity=256,
                 judge_latency=8, l1=True, volatile_bypass=True,
                 ttl_volatile=40, ttl_stable=90), True),
    (CacheConfig(0.86, 0.90, sigma_min=0.5, capacity=64,
                 judge_latency=32, judge_rate=0.25,
                 ttl_volatile=64), True),
    (CacheConfig(0.90, 0.90, sigma_min=0.0, capacity=128,
                 judge_latency=8, l1=True, ttl_volatile=48,
                 ttl_stable=200), False),
]
RW = [
    (CacheConfig(0.90, 0.90, sigma_min=0.0, capacity=128,
                 judge_latency=8, rewrite=True), True),
    (CacheConfig(0.86, 0.90, sigma_min=0.5, capacity=64,
                 judge_latency=32, judge_rate=0.5, rewrite=True,
                 rewrite_rate=0.02), True),
    (CacheConfig(0.90, 0.90, sigma_min=0.5, capacity=256,
                 judge_latency=8, l1=True, ttl_stable=90,
                 rewrite=True), True),
    (CacheConfig(0.90, 0.90, sigma_min=0.0, capacity=128,
                 judge_latency=8), True),
]
GROUPS = {"plain": PLAIN, "fresh": FRESH, "rw": RW}
UNIFORM_LAT = 16
FIELDS = tsim.SimResult._fields


def _dyadic(x):
    return (np.round(np.asarray(x, np.float64) * 256) / 256).astype(
        np.float32)


@pytest.fixture(scope="module")
def trace():
    """The dyadic trace and its channels (the volatile draw comes after
    the embeddings, so they equal the plain preset's)."""
    spec = dataclasses.replace(LMARENA_LIKE, n_requests=N_REQ + 500,
                               n_classes=400, n_topics=16,
                               volatile_frac=0.3)
    b = build_benchmark(spec)
    return dict(s_emb=_dyadic(b.static_emb), s_cls=b.static_cls,
                q_emb=_dyadic(b.eval_emb[:N_REQ]), q_cls=b.eval_cls[:N_REQ],
                key=b.eval_key[:N_REQ], vol=b.eval_volatile[:N_REQ],
                rw=np.random.default_rng(11).random(N_REQ) < 0.6,
                flip=np.random.default_rng(3).random(N_REQ) < 0.1)


def _channels(tr, group, flips=False, n=N_REQ):
    """The per-request channels each group's configs read, as keyword
    arguments common to both simulators and the oracle."""
    kw = {}
    if group == "fresh":
        kw = dict(volatile=tr["vol"][:n], key_id=tr["key"][:n],
                  drift_every=DRIFT)
    elif group == "rw":
        kw = dict(key_id=tr["key"][:n], rewritable=tr["rw"][:n])
    if flips:
        kw["judge_flip"] = tr["flip"][:n]
    return kw


def _args(tr, n=N_REQ):
    return tr["s_emb"], tr["s_cls"], tr["q_emb"][:n], tr["q_cls"][:n]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same(got, want, label):
    """Field-by-field identity; ``want`` is a SimResult or the oracle's
    dict, ``got`` the port's SimResult."""
    want = want if isinstance(want, dict) else want._asdict()
    for name in FIELDS:
        g, w = _np(getattr(got, name)), _np(want[name])
        assert g.shape == w.shape, f"{label}: {name} shape {g.shape} {w.shape}"
        assert np.array_equal(g, w), (
            f"{label}: field {name} diverges "
            f"({int(np.sum(g != w))} mismatches)" if g.shape
            else f"{label}: {name} {g} != {w}")


_REF_CACHE = {}


def _ref(tr, group, i, cfg, krites, flips=False, n=N_REQ):
    key = (group, i, cfg, krites, flips, n)
    if key not in _REF_CACHE:
        _REF_CACHE[key] = ref_simulate(*_args(tr, n), cfg, krites,
                                       **_channels(tr, group, flips, n))
    return _REF_CACHE[key]


def _port_sweep(tr, group, cfgs, krs, flips=False, **kw):
    return tsim.simulate_sweep(*_args(tr), tsim.sweep_from_configs(cfgs, krs),
                               device="cpu", **_channels(tr, group, flips),
                               **kw)


def _uniform(cfgs):
    return [dataclasses.replace(c, judge_latency=UNIFORM_LAT) for c in cfgs]


# ---------------------------------------------------------------------------
# every config through simulate (blocked core) against the numpy oracle
# ---------------------------------------------------------------------------

CASES = [(g, i, False) for g, cs in GROUPS.items() for i in range(len(cs))]
CASES.append(("plain", 1, True))      # noisy-verifier false approvals


@pytest.mark.parametrize("group,idx,flips", CASES,
                         ids=[f"{g}{i}{'-flips' if f else ''}"
                              for g, i, f in CASES])
def test_simulate_matches_reference(trace, group, idx, flips):
    cfg, krites = GROUPS[group][idx]
    res = tsim.simulate(*_args(trace), cfg, krites, device="cpu",
                        **_channels(trace, group, flips))
    ref = _ref(trace, group, idx, cfg, krites, flips)
    _assert_same(res, ref, f"simulate {group}{idx}")
    assert res.served_by.dtype == torch.int8 and res.served_by.shape == (N_REQ,)
    sb = ref["served_by"]
    # each feature the config turns on is actually exercised
    if cfg.l1:
        assert (sb == tsim.L1_HIT).sum() > 0
    if cfg.ttl_volatile or cfg.ttl_stable:
        assert ref["ttl_evicted"] > 0
    if cfg.volatile_bypass:
        assert ref["bypassed"] > 0 and ref["stale"].sum() == 0
    if group == "fresh" and not cfg.volatile_bypass:
        assert ref["stale"].sum() > 0
    if cfg.rewrite and idx == 0:
        assert ref["rewrites"] > 0 and (sb == tsim.REWRITTEN_HIT).sum() > 0
    if cfg.rewrite_rate < 1.0:
        assert ref["rewrite_dropped"] > 0
    if cfg.judge_rate < 1.0 and krites:
        assert ref["enq_dropped"] > 0
    if flips:
        assert ref["judge_approved"] > 0


# ---------------------------------------------------------------------------
# sweeps: both cores against the oracle and against JAX
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_runs(trace):
    """The six JAX programs of this file, each run once (see the module
    docstring), and how many programs they compiled (``compiles``)."""
    before = jsim._run_sweep._cache_size()
    out = {}
    for group, cfgs in GROUPS.items():
        krs = [k for _, k in cfgs]
        flips = group == "plain"
        for core, cs in (("blocked", _uniform([c for c, _ in cfgs])),
                         ("step", [c for c, _ in cfgs])):
            jcfgs = [JCacheConfig(**dataclasses.asdict(c)) for c in cs]
            kw = _channels(trace, group, flips and core == "step")
            out[f"{group}-{core}"] = jsim.simulate_sweep(
                *(jnp.asarray(a) for a in _args(trace)),
                jsim.sweep_from_configs(jcfgs, krs),
                **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                   for k, v in kw.items()})
    out["compiles"] = jsim._run_sweep._cache_size() - before
    return out


@pytest.fixture(scope="module")
def port_runs(trace):
    """The port's runs of the same six sweeps."""
    out = {}
    for group, cfgs in GROUPS.items():
        krs = [k for _, k in cfgs]
        out[f"{group}-blocked"] = _port_sweep(
            trace, group, _uniform([c for c, _ in cfgs]), krs)
        out[f"{group}-step"] = _port_sweep(
            trace, group, [c for c, _ in cfgs], krs, flips=group == "plain")
    return out


RUNS = [f"{g}-{c}" for g in GROUPS for c in ("blocked", "step")]


@pytest.mark.parametrize("run", RUNS)
def test_sweep_matches_jax(port_runs, jax_runs, run):
    _assert_same(port_runs[run], jax_runs[run], f"sweep {run} vs JAX")


@pytest.mark.parametrize("run", RUNS)
def test_sweep_matches_reference_per_config(trace, port_runs, run):
    group, core = run.split("-")
    cfgs = GROUPS[group]
    flips = group == "plain" and core == "step"
    for i, (cfg, krites) in enumerate(cfgs):
        if core == "blocked":
            cfg = dataclasses.replace(cfg, judge_latency=UNIFORM_LAT)
        _assert_same(tsim.slice_config(port_runs[run], i),
                     _ref(trace, group, i, cfg, krites, flips),
                     f"{run} cfg{i}")


def test_dispatch_follows_latency_uniformity(monkeypatch, trace):
    """Blocked core iff every swept judge_latency is the same, as in the
    reference: a single-config simulate always takes the blocked core."""
    seen = []
    for name in ("_scan_core", "_scan_core_blocked"):
        real = getattr(tsim, name)
        monkeypatch.setattr(tsim, name, lambda *a, _r=real, _n=name, **k:
                            seen.append(_n) or _r(*a, **k))
    n = 100
    cfg = CacheConfig(0.9, 0.9, capacity=32, judge_latency=8)
    args = _args(trace, n)
    tsim.simulate(*args, cfg, True, device="cpu")
    tsim.simulate_sweep(*args, tsim.sweep_from_configs([cfg, cfg], True),
                        device="cpu")
    tsim.simulate_sweep(*args, tsim.sweep_from_configs(
        [cfg, dataclasses.replace(cfg, judge_latency=9)], True),
        device="cpu")
    assert seen == ["_scan_core_blocked", "_scan_core_blocked", "_scan_core"]


# ---------------------------------------------------------------------------
# index edge cases: latency 1 and == ring, ring > latency, a trace shorter
# than the latency, lengths that are not a multiple of the 64-step window
# ---------------------------------------------------------------------------

EDGES = [
    # (n, latency, ring): latency 1 over a ragged length
    (65, 1, None),
    # latency == ring == the window: the due slot is the slot written
    # this step
    (700, 64, None),
    # a ring longer than the latency, not a multiple of it
    (300, 8, 100),
    # a trace shorter than the latency: nothing ever comes due
    (40, 64, None),
    # one step past the latency: exactly one task can come due, in the
    # second window
    (65, 64, None),
    (1, 8, None),
]


@pytest.mark.parametrize("n,lat,ring", EDGES,
                         ids=[f"n{n}-lat{lat}-ring{r}" for n, lat, r in EDGES])
def test_index_edge_cases_match_reference(trace, n, lat, ring):
    cfg = CacheConfig(0.90, 0.90, sigma_min=0.0, capacity=32,
                      judge_latency=lat)
    other = dataclasses.replace(cfg, judge_latency=max(1, lat // 2),
                                capacity=16)
    ref = ref_simulate(*_args(trace, n), cfg, True)
    got = tsim.simulate_sweep(*_args(trace, n),
                              tsim.sweep_from_configs([cfg, cfg], True),
                              ring=ring, device="cpu")
    _assert_same(tsim.slice_config(got, 0), ref, f"blocked n={n} lat={lat}")
    mixed = tsim.simulate_sweep(*_args(trace, n),
                                tsim.sweep_from_configs([cfg, other], True),
                                ring=ring, device="cpu")
    if lat > 1:
        _assert_same(tsim.slice_config(mixed, 0), ref,
                     f"stepwise n={n} lat={lat}")
        _assert_same(tsim.slice_config(mixed, 1),
                     ref_simulate(*_args(trace, n), other, True),
                     f"stepwise n={n} lat={other.judge_latency}")
    if n < lat:
        assert ref["judge_calls"] == 0


def test_padding_steps_change_no_counter(trace):
    """The window is 64 steps; a trace of 65 requests and its first 64
    requests must agree on the first 64 outputs, and the 65th request
    adds at most one judge call, one enqueue and one promotion."""
    cfg = CacheConfig(0.90, 0.90, capacity=32, judge_latency=1)
    a = tsim.simulate(*_args(trace, 64), cfg, True, device="cpu")
    b = tsim.simulate(*_args(trace, 65), cfg, True, device="cpu")
    for name in FIELDS[:4]:
        assert torch.equal(getattr(a, name), getattr(b, name)[:64]), name
    for name in FIELDS[4:]:
        assert 0 <= int(getattr(b, name)) - int(getattr(a, name)) <= 1, name


def test_capacity_and_ring_limits_raise(trace):
    cfg = CacheConfig(0.9, 0.9, capacity=64, judge_latency=8)
    sw = tsim.sweep_from_configs([cfg], True)
    with pytest.raises(ValueError, match="capacity"):
        tsim.simulate_sweep(*_args(trace, 10), sw, max_capacity=32,
                            device="cpu")
    with pytest.raises(ValueError, match="ring"):
        tsim.simulate_sweep(*_args(trace, 10), sw, ring=4, device="cpu")
    l1 = tsim.sweep_from_configs([dataclasses.replace(cfg, l1=True)], True)
    with pytest.raises(ValueError, match="key_id"):
        tsim.simulate_sweep(*_args(trace, 10), l1, device="cpu")


# ---------------------------------------------------------------------------
# summaries against JAX's (tests/test_summaries.py, tests/test_sweep.py)
# ---------------------------------------------------------------------------

def _same_summary(got: dict, want: dict, label):
    assert got.keys() == want.keys(), label
    for k, w in want.items():
        if isinstance(w, float):
            assert abs(got[k] - w) <= RATE_TOL, f"{label}: {k} {got[k]} {w}"
        else:
            assert got[k] == w and type(got[k]) is type(w), \
                f"{label}: {k} {got[k]!r} {w!r}"


@pytest.mark.parametrize("run", ["fresh-step", "rw-blocked"])
def test_summarize_sweep_matches_jax(port_runs, jax_runs, run):
    got, want = tsim.summarize_sweep(port_runs[run]), \
        jsim.summarize_sweep(jax_runs[run])
    assert len(got) == len(want) == len(GROUPS[run.split("-")[0]])
    for k, (g, w) in enumerate(zip(got, want)):
        _same_summary(g, w, f"{run} cfg{k}")
        _same_summary(tsim.summarize(tsim.slice_config(port_runs[run], k)),
                      w, f"{run} summarize(slice_config({k}))")


def _hand_built(mod, sb, correct, so, stale=None, **counters):
    c = dict(judge_calls=0, judge_approved=0, promotions=0, enq_dropped=0,
             ttl_evicted=0, bypassed=0)
    c.update(counters)
    stale = [False] * len(sb) if stale is None else stale
    if mod is tsim:
        return tsim.SimResult(
            torch.tensor(sb, dtype=torch.int8), torch.tensor(correct),
            torch.tensor(so), torch.tensor(stale),
            *(torch.tensor(v, dtype=torch.int32) for v in c.values()))
    return jsim.SimResult(
        jnp.asarray(sb, jnp.int8), jnp.asarray(correct, bool),
        jnp.asarray(so, bool), jnp.asarray(stale, bool),
        *(jnp.int32(v) for v in c.values()))


HAND = {
    # 8 requests: 2 static, 1 dynamic, 2 promoted, 3 misses; one wrong
    # dynamic answer and one wrong promoted answer
    "mixed": ([1, 0, 2, 3, 0, 1, 3, 0],
              [True, True, False, True, True, True, False, True],
              [True, False, False, True, False, True, True, False],
              None, dict(judge_calls=5, judge_approved=3, promotions=2,
                         enq_dropped=1)),
    "all-miss": ([0] * 4, [True] * 4, [False] * 4, None, {}),
    # wrong flags on misses never count as errors
    "miss-wrong": ([0, 0], [False, False], [False, False], None, {}),
    # L1, rewritten and stale serves
    "fresh": ([4, 5, 1, 2, 0, 4],
              [True, True, True, True, True, False],
              [True, True, True, False, False, False],
              [False, False, True, True, False, False],
              dict(ttl_evicted=2, bypassed=1)),
}


@pytest.mark.parametrize("name", list(HAND))
def test_summarize_hand_built_matches_jax(name):
    sb, ok, so, stale, ctr = HAND[name]
    _same_summary(tsim.summarize(_hand_built(tsim, sb, ok, so, stale, **ctr)),
                  jsim.summarize(_hand_built(jsim, sb, ok, so, stale, **ctr)),
                  name)


@pytest.mark.parametrize("n_points", [1, 7, 100])
def test_coverage_curve_matches_jax(port_runs, jax_runs, n_points):
    for k in range(2):
        pts, cum = tsim.coverage_curve(
            tsim.slice_config(port_runs["plain-blocked"], k), n_points)
        jpts, jcum = jsim.coverage_curve(
            jsim.slice_config(jax_runs["plain-blocked"], k), n_points)
        assert pts.dtype == torch.int32 and cum.dtype == torch.float32
        assert np.array_equal(pts.numpy(), np.asarray(jpts))
        np.testing.assert_allclose(cum.numpy(), np.asarray(jcum),
                                   rtol=0, atol=RATE_TOL)


def test_coverage_curve_points_on_ragged_lengths():
    """The sample points follow JAX's fp32 linspace on lengths where a
    float row index lands next to an integer."""
    for n in (999, 2000):
        so = np.random.default_rng(n).random(n) < 0.3
        mk = [_hand_built(m, [1 if x else 0 for x in so], [True] * n,
                          list(so)) for m in (tsim, jsim)]
        for n_points in (50, 101):
            pts, cum = tsim.coverage_curve(mk[0], n_points)
            jpts, jcum = jsim.coverage_curve(mk[1], n_points)
            assert np.array_equal(pts.numpy(), np.asarray(jpts)), (n, n_points)
            np.testing.assert_allclose(cum.numpy(), np.asarray(jcum),
                                       rtol=0, atol=RATE_TOL)


def test_sweep_grid_row_major_matches_jax():
    base = CacheConfig(0.9, 0.9, capacity=64, judge_latency=4)
    axes = dict(tau_static=[0.8, 0.9], tau_dynamic=[0.85, 0.95, 0.99],
                capacity=[16, 64])
    got = tsim.sweep_grid(base, krites=True, **axes)
    want = jsim.sweep_grid(JCacheConfig(**dataclasses.asdict(base)),
                           krites=True, **axes)
    assert got.n == want.n == 12
    for name in tsim.SweepConfig._fields:
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert g.numpy().dtype == w.dtype and np.array_equal(g.numpy(), w), \
            name
    # last axis fastest, like itertools.product
    assert got.capacity.tolist()[:4] == [16, 64, 16, 64]
    assert got.tau_static.tolist()[:6] == pytest.approx([0.8] * 6)


def test_sweep_from_configs_broadcasts_krites():
    cfgs = [c for c, _ in PLAIN]
    one = tsim.sweep_from_configs(cfgs, True)
    per = tsim.sweep_from_configs(cfgs, [k for _, k in PLAIN])
    assert one.krites.tolist() == [True] * len(cfgs)
    assert per.krites.tolist() == [k for _, k in PLAIN]
    assert one.n == len(cfgs) and one.dedup.tolist()[-1] is False


# ---------------------------------------------------------------------------
# a float trace: identical, or identical up to a first divergence whose
# deciding score lies within NEAR of a threshold
# ---------------------------------------------------------------------------

def _first_divergence(res, ref):
    diff = np.zeros(len(ref["served_by"]), bool)
    for name in FIELDS[:4]:
        diff |= _np(getattr(res, name)) != ref[name]
    idx = np.flatnonzero(diff)
    return int(idx[0]) if len(idx) else None


def _margin(s_emb, q_emb, cfg, t):
    """Smallest distance, in fp64, between a threshold and a score that
    can decide request t: its static top-1 (against tau_static and
    sigma_min) and the top-1/top-2 gap, its similarity to every earlier
    request (any of which may sit in the dynamic tier) against
    tau_dynamic, and the delayed query's against dup_threshold."""
    q = q_emb.astype(np.float64)
    st = np.sort(s_emb.astype(np.float64) @ q[t])[::-1]
    m = [abs(st[0] - cfg.tau_static), abs(st[0] - cfg.sigma_min),
         st[0] - st[1]]
    if t:
        m.append(np.min(np.abs(q[:t] @ q[t] - cfg.tau_dynamic)))
        src = t - max(1, cfg.judge_latency)
        if src >= 0:
            m.append(np.min(np.abs(q[:t] @ q[src] - cfg.dup_threshold)))
    return float(min(m))


def test_float_trace_matches_reference_up_to_near_threshold():
    spec = dataclasses.replace(LMARENA_LIKE, n_requests=N_REQ + 500,
                               n_classes=400, n_topics=16, seed=5)
    b = build_benchmark(spec)
    args = (b.static_emb, b.static_cls, b.eval_emb[:N_REQ],
            b.eval_cls[:N_REQ])
    near = []
    for i, (cfg, krites) in enumerate(PLAIN[:3]):
        res = tsim.simulate(*args, cfg, krites, device="cpu")
        ref = ref_simulate(*args, cfg, krites)
        t = _first_divergence(res, ref)
        if t is None:
            _assert_same(res, ref, f"float cfg{i}")
            continue
        m = _margin(b.static_emb, b.eval_emb[:N_REQ], cfg, t)
        assert m <= NEAR, (f"float cfg{i}: first divergence at request "
                           f"{t}, every deciding score {m:.3g} from a "
                           "threshold")
        near.append((i, t, m))
    print(f"float trace: {len(near)} of 3 configs diverge, each first at a "
          f"score within {NEAR} of a threshold: {near}")


def test_jax_compile_budget(jax_runs):
    """The file's JAX simulator runs, all in ``jax_runs``, compile at
    most six programs (fewer where an earlier file in the same process
    compiled the same shapes)."""
    assert 0 <= jax_runs["compiles"] <= 6
