"""Port parity: the operability layer against the JAX package on the CPU.

Scripted scenarios, each a small case of a JAX test file:

- the L1 front, volatile bypass, per-class TTLs and drift accounting
  (``test_l1_freshness.py``) and the three-outcome rewrite path
  (``test_rewrite_durability.py``, ``test_verdict_backcompat.py``): one
  trace through the JAX ``KritesPolicy`` and the port's, scalar and
  batched, with identical per-request decisions, meta, host mirrors,
  ``stats()`` and promotion journals;
- the promotion WAL (``test_promo_wal_properties.py``): frames
  byte-identical for the same appends, torn tails and compaction alike,
  and the port's ``compact`` keeping the journal's numbering where the
  reference loses it;
- adaptive thresholds (``test_adaptive.py``): the same operating points
  chosen by ``maybe_adapt`` on the same window, controller-level and
  through a serving policy.

Every embedding is dyadic (entries k/8, unit norm exactly), so every
similarity is exact in either framework and in any summation order.
Judge pools run one worker and are drained after each batch; every file
lives under ``tmp_path``; every pool is stopped (its threads joined).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import tiers as JT
from repro.core.adaptive import AdaptiveController as JController
from repro.core.adaptive import AdaptiveParams as JParams
from repro.core.freshness import FreshnessPolicy as JFreshness
from repro.core.judge import OracleJudge as JOracle
from repro.core.judge import template_rewriter as j_rewriter
from repro.core import promo_wal as jwal
from repro.core.policy import KritesPolicy as JKrites
from repro_torch.core import promo_wal as pwal
from repro_torch.core import tiers as T
from repro_torch.core.adaptive import AdaptiveController, AdaptiveParams
from repro_torch.core.freshness import FreshnessPolicy
from repro_torch.core.judge import OracleJudge, template_rewriter
from repro_torch.core.policy import KritesPolicy

torch.set_num_threads(1)

D, S, CAP = 32, 8, 12
E = np.eye(D, dtype=np.float32)


def _grey(i: int, hi: bool = False) -> np.ndarray:
    """A unit vector at cosine 0.75 (or 0.875) to static row ``i``,
    with dyadic entries: every dot product with the pool is exact."""
    j = (i + 1) % 8
    if hi:
        return (0.875 * E[i] + 0.25 * (E[8 + i] + E[16 + i] + E[24 + i])
                + 0.125 * (E[8 + j] + E[16 + j] + E[24 + j]))
    return (0.75 * E[i] + 0.5 * E[8 + i]
            + 0.25 * (E[16 + i] + E[24 + i] + E[16 + j]))


def _workload():
    """{text: vector} and the (text, cls) pool a trace draws from:
    static hits, grey-zone pairs of matching (approve) and other
    (reject or rewrite) class, misses, and for each vector a second
    text (a semantic repeat the L1 does not alias), across the three
    freshness classes."""
    vec, pool = {}, []
    for i in range(S):
        vec[f"define s{i}"] = E[i]
        pool.append((f"define s{i}", i))
        for txt, c in ((f"define g{i}", i), (f"price of g{i}", 100 + i)):
            vec[txt] = vec[txt + " again"] = _grey(i)
            pool += [(txt, c), (txt + " again", c)]
    for j in range(10):
        for txt in (f"tell me about m{j}", f"latest m{j}"):
            vec[txt] = vec[txt + " again"] = E[16 + j]
            pool += [(txt, -1), (txt + " again", -1)]
    return vec, pool


VEC, POOL = _workload()


def _trace(n: int, seed: int):
    rng = np.random.default_rng(seed)
    return [POOL[int(k)] for k in rng.integers(0, len(POOL), n)]


def _jax_static():
    return JT.StaticTier(emb=jnp.asarray(E[:S]),
                         cls=jnp.arange(S, dtype=jnp.int32),
                         answer_ref=jnp.arange(S, dtype=jnp.int32))


def _port_static():
    return T.StaticTier(torch.tensor(E[:S]),
                        torch.arange(S, dtype=torch.int32),
                        torch.arange(S, dtype=torch.int32))


def _pair(cfg_kw: dict, *, fresh: dict | None = None, l1=None,
          rewritable: bool = False, rewriter: bool = False, wal_dir=None,
          adaptive: dict | None = None, frozen: bool = False):
    """(JAX policy, port policy) built from the same settings."""
    out = []
    for pkg in ("jax", "port"):
        jx = pkg == "jax"
        cfg = (JT if jx else T).CacheConfig(0.92, 0.9, sigma_min=0.3,
                                            capacity=CAP, **cfg_kw)
        fr = None if fresh is None else \
            (JFreshness if jx else FreshnessPolicy)(**fresh)
        judge = (JOracle if jx else OracleJudge)(
            freshness=fr, rewritable=(lambda qc, hc, qt, ht: True)
            if rewritable else None)
        ctl = None
        if adaptive is not None:
            ctl = (JController if jx else AdaptiveController)(
                cfg, d=D, params=(JParams if jx else AdaptiveParams)(
                    **adaptive), frozen=frozen)
        wal = None
        if wal_dir is not None:
            wal = (jwal if jx else pwal).PromotionWAL(
                wal_dir / f"{pkg}.wal", fsync_every=1)
        kw = dict(backend_fn=lambda p: f"gen({p})", d=D, n_workers=1,
                  l1=l1, freshness=fr, wal=wal, adaptive=ctl,
                  rewriter=(j_rewriter if jx else template_rewriter)
                  if rewriter else None)
        if jx:
            out.append(JKrites(cfg, _jax_static(), [f"a{i}" for i in
                                                    range(S)],
                               VEC.__getitem__, judge_fn=judge, **kw))
        else:
            out.append(KritesPolicy(cfg, _port_static(),
                                    [f"a{i}" for i in range(S)],
                                    VEC.__getitem__, judge_fn=judge,
                                    device="cpu", **kw))
    return out


def _dec(r):
    return (r.served_by, None if r.answer is None else str(r.answer),
            bool(r.static_origin), float(r.similarity),
            bool(r.meta.get("stale")), r.meta.get("bypass"))


_MIRRORS = ("_valid_np", "_last_used_np", "_static_origin_np",
            "_written_at_np", "_expires_np", "_rewritten_np")


def _same_state(jp, pp, where):
    for f in _MIRRORS:
        assert np.array_equal(getattr(jp, f), getattr(pp, f)), (where, f)
    assert jp.dyn_answers == pp.dyn_answers, where
    assert jp.t == pp.t, where
    for f in JT.DynamicTier._fields:
        assert np.array_equal(np.asarray(getattr(jp.dyn, f)),
                              getattr(pp.dyn, f).numpy()), (where, f)


def _run_pair(jp, pp, trace, batch):
    """Serve ``trace`` through both policies (scalar when ``batch`` is
    None), draining both pools after each call; every decision and the
    state after each call must agree. Returns the decisions."""
    got = []
    step = batch or 1
    for b0 in range(0, len(trace), step):
        chunk = trace[b0:b0 + step]
        prompts = [p for p, _ in chunk]
        metas = [{"cls": c} if c >= 0 else None for _, c in chunk]
        if batch is None:
            want = [jp.serve(prompts[0], metas[0])]
            out = [pp.serve(prompts[0], metas[0])]
        else:
            want = jp.serve_batch(prompts, metas)
            out = pp.serve_batch(prompts, metas)
        jp.pool.drain()
        pp.pool.drain()
        assert [_dec(r) for r in out] == [_dec(r) for r in want], b0
        _same_state(jp, pp, b0)
        got += [_dec(r) for r in out]
    return got


CASES = {
    # L1 front + volatile bypass + per-class TTLs (unknown dies fast)
    "l1-bypass-ttl": dict(
        l1=16, fresh=dict(volatile_bypass=True, ttl_volatile=0,
                          ttl_stable=20, ttl_unknown=6)),
    # a small L1 under LRU pressure, volatile entries cached with a
    # short TTL and flagged stale across drift epochs
    "l1-ttl-drift": dict(
        l1=4, fresh=dict(volatile_bypass=False, ttl_volatile=5,
                         ttl_stable=0, ttl_unknown=0, drift_every=8)),
    # three-outcome verdicts, half the rewrites rate-limited, journaled
    "rewrite": dict(cfg_kw=dict(rewrite=True, rewrite_rate=0.5),
                    rewritable=True, rewriter=True, wal=True),
    # REWRITE verdicts with no rewriter degrade to rewrite_failed
    "rewrite-missing": dict(cfg_kw=dict(rewrite=True), rewritable=True,
                            wal=True),
}


@pytest.mark.parametrize("batched", [False, True],
                         ids=["scalar", "batched"])
@pytest.mark.parametrize("case", list(CASES))
def test_operability_trace_matches_jax(case, batched, tmp_path):
    kw = dict(CASES[case])
    wal = kw.pop("wal", False)
    jp, pp = _pair(kw.pop("cfg_kw", {}), wal_dir=tmp_path if wal else None,
                   **kw)
    try:
        decs = _run_pair(jp, pp, _trace(60, seed=len(case)),
                         6 if batched else None)
        js, ps = jp.stats(), pp.stats()
        assert js == ps
    finally:
        jp.pool.stop()
        pp.pool.stop()
        for pol in (jp, pp):
            if pol.wal is not None:
                pol.wal.close()
    by = {d[0] for d in decs}
    assert {"static", "dynamic", "backend"} <= by, by
    if kw.get("l1"):
        assert ps["l1_hits"] > 0 and "l1" in by
    if case == "l1-bypass-ttl":
        assert ps["l1_bypass_volatile"] > 0 and ps["ttl_evictions"] > 0
    if case == "l1-ttl-drift":
        assert ps["stale_serves"] > 0
    if case == "rewrite":
        assert "rewritten" in by and ps["rewritten"] > 0
        assert ps["rewrite_rate_limited"] > 0
    if case == "rewrite-missing":
        assert ps["rewrite_failed"] > 0 and ps["rewritten"] == 0
    if wal:
        # the promotions were journaled in the same order, frame for frame
        assert (tmp_path / "port.wal").read_bytes() \
            == (tmp_path / "jax.wal").read_bytes()
        assert ps["wal_seq"] > 0


# ---------------------------------------------------------------------------
# promotion WAL
# ---------------------------------------------------------------------------

def _records(n: int):
    rng = np.random.default_rng(5)
    out = []
    for k in range(n):
        rw = k % 3 == 2
        out.append(dict(v=rng.normal(size=D).astype(np.float32),
                        h_idx=int(k % S), enq_t=10 + k, ttl=k % 4,
                        q_text=f"q{k} ünï", h_text=f"h{k}",
                        outcome="rewrite" if rw else "approve",
                        rewritten=f"tailored {k}" if rw else "",
                        q_cls=k if rw else -1))
    return out


def test_wal_frames_byte_identical(tmp_path):
    """Same appends -> the same bytes; the same torn-tail recovery and
    the same compaction (when records past the cursor remain)."""
    recs = _records(9)
    paths = {}
    for name, mod in (("jax", jwal), ("port", pwal)):
        p = paths[name] = tmp_path / f"{name}.wal"
        with mod.PromotionWAL(p, fsync_every=4) as w:
            seqs = [w.append(mod.encode_record(
                r["v"], r["h_idx"], r["enq_t"], **{
                    k: r[k] for k in ("ttl", "q_text", "h_text",
                                      "outcome", "rewritten", "q_cls")}))
                    for r in recs]
        assert seqs == list(range(1, 10))
    assert paths["jax"].read_bytes() == paths["port"].read_bytes()
    got, clean = pwal.read_wal(paths["port"])
    assert clean and got == jwal.read_wal(paths["jax"])[0]
    assert np.array_equal(pwal.decode_vector(got[4]), recs[4]["v"])

    # a crash mid-append: both reopen onto the same valid prefix
    for name, mod in (("jax", jwal), ("port", pwal)):
        p = paths[name]
        p.write_bytes(p.read_bytes()[:-7])
        with mod.PromotionWAL(p, fsync_every=1) as w:
            assert w.seq == 8
            w.append(mod.encode_record(recs[0]["v"], 1, 99))
    assert paths["jax"].read_bytes() == paths["port"].read_bytes()

    assert jwal.compact(paths["jax"], keep_from_seq=5) \
        == pwal.compact(paths["port"], keep_from_seq=5) == 4
    assert paths["jax"].read_bytes() == paths["port"].read_bytes()
    rj = jwal.replay_into(_Sink(), paths["port"], skip=5)
    rp = pwal.replay_into(_Sink(), paths["jax"], skip=5)
    assert rj == rp == {"records": 4, "skipped": 0, "replayed": 4,
                        "clean": True}


class _Sink:
    """Stands in for a policy in ``replay_into``: records the payloads."""

    def __init__(self):
        self.seen = []

    def _promote(self, payload, journal=True):
        assert journal is False
        self.seen.append(payload)


def test_compact_keeps_seq_where_the_reference_loses_it(tmp_path):
    """ROADMAP's falsifying example of
    ``test_promo_wal_properties::test_compact_preserves_cursor_and_seq``:
    ``ops=[(0, 0, 1)], keep_frac=1.0`` — one promotion journaled, then a
    snapshot at ``wal_seq=1`` compacts the journal to its cursor.

    Divergence from the reference, on purpose: the reference's
    ``compact`` writes a header-only file, the reopened WAL restarts at
    seq 0 and stamps the next append 1, at the snapshot's cursor, so
    ``replay_into(skip=1)`` skips it after a crash (a lost promotion).
    The port's ``compact`` keeps the newest record as an anchor: the
    reopened WAL continues at 1, the next append is stamped 2 and
    replays; replay skips the anchor. The file stays readable by the
    reference, which replays the same records."""
    v = E[S + 3]
    rec = dict(v=v, h_idx=0, enq_t=1)
    for name, mod in (("jax", jwal), ("port", pwal)):
        with mod.PromotionWAL(tmp_path / f"{name}.wal", fsync_every=1) as w:
            assert w.append(mod.encode_record(**rec)) == 1
    assert jwal.compact(tmp_path / "jax.wal", keep_from_seq=1) == 0
    assert pwal.compact(tmp_path / "port.wal", keep_from_seq=1) == 0

    with jwal.PromotionWAL(tmp_path / "jax.wal", fsync_every=1) as w:
        assert w.seq == 0                     # the reference's fault
        assert w.append(jwal.encode_record(v, 1, 2)) == 1
    assert jwal.replay_into(_Sink(), tmp_path / "jax.wal",
                            skip=1)["replayed"] == 0

    with pwal.PromotionWAL(tmp_path / "port.wal", fsync_every=1) as w:
        assert w.seq == 1                     # numbering kept
        assert w.append(pwal.encode_record(v, 1, 2)) == 2
    for mod in (pwal, jwal):                  # both packages read it
        sink = _Sink()
        assert mod.replay_into(sink, tmp_path / "port.wal", skip=1) \
            == {"records": 2, "skipped": 1, "replayed": 1, "clean": True}
        assert sink.seen[0]["enq_t"] == 2

    # the same example through a policy: state at the cursor plus the
    # replayed tail reaches the live state
    path = tmp_path / "live.wal"
    _, live = _pair({}, wal_dir=None)
    recovered = None
    try:
        live.wal = pwal.PromotionWAL(path, fsync_every=1)
        live._promote({"v": v, "h_idx": 0, "enq_t": 1})
        live.wal.close()
        assert pwal.compact(path, keep_from_seq=1) == 0
        live.wal = pwal.PromotionWAL(path, fsync_every=1)
        live._promote({"v": E[S + 4], "h_idx": 1, "enq_t": 2})
        live.wal.close()
        _, recovered = _pair({}, wal_dir=None)
        recovered._promote({"v": v, "h_idx": 0, "enq_t": 1},
                           journal=False)          # the snapshot's state
        rep = pwal.replay_into(recovered, path, skip=1)
        assert rep["replayed"] == 1
        _same_state(live, recovered, "compacted")
    finally:
        live.pool.stop()
        if recovered is not None:
            recovered.pool.stop()


# ---------------------------------------------------------------------------
# adaptive thresholds
# ---------------------------------------------------------------------------

ADAPT = dict(window=64, adapt_every=32, min_segment=16, shadow_capacity=16,
             grid_points=3, grid_radius=0.04, max_step=0.02,
             hysteresis=0.0, epsilon=0.5)


def test_maybe_adapt_matches_jax_on_a_dyadic_window():
    """Both controllers record the same window (dyadic keys at cosine
    0.875 and 0.75 to the static rows, some labels rewritten by verdicts
    and feedback) and adapt over the same static tier: the same
    operating points, counters and state, sweep after sweep."""
    cfg_j = JT.CacheConfig(0.92, 0.9, capacity=CAP)
    cfg_p = T.CacheConfig(0.92, 0.9, capacity=CAP)
    jc = JController(cfg_j, d=D, params=JParams(**ADAPT))
    pc = AdaptiveController(cfg_p, d=D, params=AdaptiveParams(**ADAPT))
    lock_j, lock_p = _NoLock(), _NoLock()
    rng = np.random.default_rng(3)
    for n in range(160):
        i = int(rng.integers(0, S))
        emb = _grey(i, hi=bool(n % 3)) if n % 5 else E[16 + n % 16]
        label = i if n % 7 else i + 1
        seg = int(n % 4 == 0)     # unknown, with every 4th volatile
        for c in (jc, pc):
            seq = c.record(emb, label, seg)
            if n % 11 == 0:
                c.record_verdict(seq, False, i)
            if n % 13 == 0:
                c.record_feedback(seq, ok=False)
        ran = (jc.maybe_adapt(lock_j, jnp.asarray(E[:S]),
                              jnp.arange(S, dtype=jnp.int32)),
               pc.maybe_adapt(lock_p, torch.tensor(E[:S]),
                              torch.arange(S, dtype=torch.int32)))
        assert ran[0] == ran[1], n
        assert jc.stats() == pc.stats(), n
    assert pc.adaptations >= 3 and pc.moves > 0
    ja, js = jc.to_state()
    pa, ps = pc.to_state()
    assert js == ps
    for k in ja:
        assert np.array_equal(ja[k], pa[k]), k


class _NoLock:
    """A lock for a controller driven from one thread."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_adaptive_policy_matches_jax(tmp_path):
    """Serving with a controller attached: per-request thresholds,
    window records, judge-verdict evidence and sweeps at batch ends give
    the same decisions and the same operating points as the reference."""
    jp, pp = _pair({}, adaptive=ADAPT, l1=8)
    try:
        trace = []
        rng = np.random.default_rng(11)
        for n in range(120):
            i = int(rng.integers(0, S))
            txt = f"define h{i} v{n % 5}"
            VEC.setdefault(txt, _grey(i, hi=True))
            trace.append((txt, i if n % 6 else 100 + i))
        trace += _trace(40, seed=4)
        _run_pair(jp, pp, trace, 8)
        js, ps = jp.stats(), pp.stats()
        assert js == ps
        assert ps["adaptive_adaptations"] > 0 and ps["adaptive_moves"] > 0
        VEC["define s1 once"] = E[1]          # a static hit, recorded
        seqs = [pol.serve("define s1 once", {"cls": 1}).meta["adapt_seq"]
                for pol in (jp, pp)]
        assert seqs[0] == seqs[1]
        assert jp.feedback(seqs[0], ok=False) is True
        assert pp.feedback(seqs[1], ok=False) is True
        assert jp.stats() == pp.stats()
    finally:
        jp.pool.stop()
        pp.pool.stop()
