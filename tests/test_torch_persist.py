"""Port parity: snapshots, crash recovery and the service launcher.

Small scripted cases of ``test_persist_roundtrip.py`` and
``test_crash_recovery.py``, held against the JAX package on the CPU:

- a snapshot written by JAX restores into the port and one written by
  the port restores into JAX (L1, adaptive controller, rewrite
  provenance included): the same state, the same manifest leaves, and
  the restored policy's next 64 decisions identical to the live one's;
- kill-and-replay: a snapshot plus the WAL tail of a policy that died
  after it recovers the live state in the other package;
- the static IVF layout warm-restored across frameworks (no k-means),
  a stale one rebuilt on a joined background thread, the segmented
  dynamic index rebuilt by ``bulk_load``;
- corruption, unknown formats and topology mismatches refused;
- the launcher's service flags: a snapshot at shutdown, a JSON-lines
  stdio service, a crash after its snapshot, and a restart that
  replays the WAL tail.

Everything lives under ``tmp_path``; every pool, rebuild thread and
service is stopped and joined.
"""
import io
import json
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import promo_wal as jwal
from repro.serving import persist as jpersist
from repro_torch.core import promo_wal as pwal
from repro_torch.serving import persist as ppersist
from test_torch_operability import (ADAPT, CAP, D, E, S, VEC, _dec, _grey,
                                    _pair, _run_pair, _same_state, _trace)

torch.set_num_threads(1)

PERSIST = {"jax": jpersist, "port": ppersist}
WAL = {"jax": jwal, "port": pwal}


def _full_pair(wal_dir=None):
    """Both policies with every option that rides in a snapshot (the
    controller frozen: its window and counters persist, and its sweeps
    are held against JAX in ``test_torch_operability.py``)."""
    return _pair(dict(rewrite=True), l1=8, rewritable=True, rewriter=True,
                 adaptive=ADAPT, frozen=True, wal_dir=wal_dir,
                 fresh=dict(volatile_bypass=False, ttl_volatile=7,
                            ttl_stable=0, ttl_unknown=40))


def _fresh(pkg: str):
    pair = _full_pair()
    _stop(pair[pkg != "port"])
    return pair[pkg == "port"]


def _stop(*pols):
    for pol in pols:
        pol.pool.stop()
        if getattr(pol, "wal", None) is not None:
            pol.wal.close()


def _burst(pol, m: int, t0: int, seed: int):
    """m verdicts landing late, every third a REWRITE (re-promotions of
    one key at later enqueue times among them: LWW churn)."""
    rng = np.random.default_rng(seed)
    for k in range(m):
        i = int(rng.integers(0, S))
        rw = k % 3 == 2
        pol._promote({"v": _grey(i, hi=not rw), "h_idx": i,
                      "enq_t": t0 + k,
                      "outcome": "rewrite" if rw else "approve",
                      "rewritten": f"tailored {i}/{k}" if rw else "",
                      "judge_args": {"q_cls": 100 + i if rw else i}})
    pol.t = max(pol.t, t0 + m)


@pytest.mark.parametrize("src", ["jax", "port"],
                         ids=["jax-to-port", "port-to-jax"])
def test_snapshot_restores_across_frameworks(src, tmp_path):
    dst = "port" if src == "jax" else "jax"
    live, other = _full_pair() if src == "jax" else _full_pair()[::-1]
    _stop(other)
    restored = _fresh(dst)
    try:
        for chunk in _chunks(_trace(72, seed=8), 8):
            live.serve_batch(*chunk)
            live.pool.drain()
        _burst(live, 6, live.t + 1, seed=2)
        PERSIST[src].save_snapshot(tmp_path, live)
        rep = PERSIST[dst].restore_policy(restored, tmp_path)
        assert rep["dyn_live"] + rep["ttl_dropped"] \
            == int(live._valid_np.sum()) and rep["dyn_live"] > 0
        assert rep["adaptive_restored"] and rep["l1_restored"] > 0
        with live.dyn_lock:     # restore swept what expired at the clock
            live._sweep_expired_locked(live.t)
        jp, pp = (live, restored) if src == "jax" else (restored, live)
        _same_state(jp, pp, "restored")
        # the L1 restores its entries live at the clock, in LRU order
        alive = [e for e in live.l1.to_state() if not 0 < e[4] < live.t]
        assert restored.l1.to_state() == alive
        assert jp.adaptive.stats() == pp.adaptive.stats()
        assert live._rewritten_np.any()

        # the restored policy saves the same leaves, bit for bit, as the
        # live one does now
        again = PERSIST[dst].save_snapshot(tmp_path / "again", restored)
        path = PERSIST[src].save_snapshot(tmp_path / "live", live)
        want = json.loads((path / "manifest.json").read_text())
        got = json.loads((again / "manifest.json").read_text())
        assert got["leaves"] == want["leaves"]
        for k in ("t", "wal_seq", "dyn_answers", "adaptive",
                  "static_hash", "format"):
            assert got["extra"][k] == want["extra"][k], k

        # the next 64 decisions, in lockstep (pools drained per batch)
        hits0 = (jp._l1_hits, pp._l1_hits)
        decs = _run_pair(jp, pp, _trace(64, seed=9), 8)
        assert jp._l1_hits - hits0[0] == pp._l1_hits - hits0[1] > 0
        assert {"static", "dynamic", "backend", "l1"} <= {d[0] for d in decs}
    finally:
        _stop(live, restored)


def _chunks(trace, n):
    for b0 in range(0, len(trace), n):
        chunk = trace[b0:b0 + n]
        yield ([p for p, _ in chunk],
               [{"cls": c} if c >= 0 else None for _, c in chunk])


@pytest.mark.parametrize("src", ["jax", "port"],
                         ids=["jax-dies", "port-dies"])
def test_kill_and_replay_recovers_through_the_wal_tail(src, tmp_path):
    """The recovery recipe across frameworks: the live policy snapshots
    mid-stream, keeps journaling promotions and dies; the other package
    restores the snapshot and replays the tail past its cursor."""
    dst = "port" if src == "jax" else "jax"
    pair = _full_pair(wal_dir=tmp_path)
    live, other = pair if src == "jax" else pair[::-1]
    _stop(other)
    recovered = _fresh(dst)
    try:
        for prompts, metas in _chunks(_trace(48, seed=3), 8):
            live.serve_batch(prompts, metas)
            live.pool.drain()
        _burst(live, 5, live.t + 1, seed=4)          # journaled before
        PERSIST[src].save_snapshot(tmp_path / "snap", live)
        _burst(live, 7, live.t + 1, seed=5)          # journaled after
        live.wal.close()                             # the process dies
        snap = PERSIST[dst].load_snapshot(tmp_path / "snap")
        cursor = snap.extra["wal_seq"]
        assert cursor > 0
        PERSIST[dst].restore_policy(recovered, snap)
        rep = WAL[dst].replay_into(recovered, tmp_path / f"{src}.wal",
                                   skip=cursor)
        assert rep["skipped"] == cursor and rep["replayed"] > 0
        assert rep["clean"]
        recovered.t = live.t
        jp, pp = (live, recovered) if src == "jax" else (recovered, live)
        _same_state(jp, pp, "recovered")
        jp.wal = pp.wal = None
        _run_pair(jp, pp, _trace(32, seed=6), 8)
    finally:
        _stop(live, recovered)


def _adaptive_pair(wal_dir=None):
    return _pair({}, adaptive=ADAPT, l1=8, wal_dir=wal_dir)


def _grey_trace(n: int, seed: int, tag: str):
    """Grey-zone repeats of the static rows (every sixth of another
    class, so some verdicts reject), then the mixed trace."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        i = int(rng.integers(0, S))
        txt = f"define {tag}{i} v{k % 5}"
        VEC.setdefault(txt, _grey(i, hi=True))
        out.append((txt, i if k % 6 else 100 + i))
    return out + _trace(n // 3, seed=seed + 1)


def _controller(pol):
    with pol.dyn_lock:
        arrays, scalars = pol.adaptive.to_state()
    return {k: v.tolist() for k, v in arrays.items()}, scalars


def test_adaptive_evidence_after_the_snapshot_is_not_restored(tmp_path):
    """The promotion WAL journals the tier, not the adaptive window: a
    verdict that lands after the snapshot rewrites the live window's
    label, and snapshot + WAL tail restores the tier but not that
    label. Both packages share this limit, and diverge from live in the
    same way: the restored tiers equal the live one, the restored
    controllers equal each other and differ from live, and the next
    trace's decisions and operating points agree across packages,
    restored with restored and live with live."""
    live = _adaptive_pair(wal_dir=tmp_path)
    rest = _adaptive_pair()
    gates = []
    try:
        _run_pair(*live, _grey_trace(48, seed=21, tag="w"), 8)
        for pol in live:            # hold every verdict at the judge
            gate, judge = threading.Event(), pol._judge_fn
            pol._judge_fn = (lambda judge, gate: lambda **kw: (
                gate.wait(30), judge(**kw))[1])(judge, gate)
            gates.append(gate)
        held = _grey_trace(16, seed=22, tag="w")
        prompts = [p for p, _ in held]
        metas = [{"cls": c} for _, c in held]
        decs = [[_dec(r) for r in pol.serve_batch(prompts, metas)]
                for pol in live]
        assert decs[0] == decs[1]
        for pkg, pol in zip(("jax", "port"), live):
            PERSIST[pkg].save_snapshot(tmp_path / f"snap-{pkg}", pol)
        for gate in gates:          # the verdicts land after the snapshot
            gate.set()
        for pol in live:
            pol.pool.drain()
        _same_state(*live, "live")
        assert _controller(live[0]) == _controller(live[1])

        for pkg, pol in zip(("jax", "port"), rest):
            snap = PERSIST[pkg].load_snapshot(tmp_path / f"snap-{pkg}")
            assert PERSIST[pkg].restore_policy(pol, snap)[
                "adaptive_restored"]
            rep = WAL[pkg].replay_into(pol, tmp_path / f"{pkg}.wal",
                                       skip=snap.extra["wal_seq"])
            assert rep["replayed"] > 0 and rep["clean"]
        for lv, rs in zip(live, rest):    # the WAL restored the tier ...
            assert np.array_equal(lv._valid_np, rs._valid_np)
            assert lv.dyn_answers == rs.dyn_answers
        _same_state(*rest, "restored")
        # ... but not the verdicts' labels in the window
        want, got = _controller(live[1]), _controller(rest[1])
        assert got[0]["label"] != want[0]["label"]
        assert got[1]["verdicts"] < want[1]["verdicts"]
        assert _controller(rest[0]) == got

        after = _grey_trace(48, seed=23, tag="w")
        for pol in live:
            pol.wal.close()
            pol.wal = None
        for pair in (live, rest):
            _run_pair(*pair, after, 8)
            assert pair[0].stats() == pair[1].stats()
            assert _controller(pair[0]) == _controller(pair[1])
        assert live[1].adaptive.adaptations > 0
    finally:
        for gate in gates:
            gate.set()
        _stop(*live, *rest)


def _ivf_pair():
    from repro.index.ivf import IVFIndex as JIVFIndex
    from repro.index.ivf import build_ivf as jbuild
    jp, pp = _pair({})
    jp.index = JIVFIndex(jbuild(jp.static.emb, n_clusters=2, iters=2,
                                corpus_normalized=True),
                         nprobe=2, n_candidates=S)
    return jp, pp


def test_ivf_warm_restore_across_frameworks(tmp_path):
    """A JAX-built IVF layout in a JAX snapshot warm-restores into the
    port through ``ivf_from_numpy`` (no k-means) and serves the JAX
    policy's decisions; a port snapshot of it restores into JAX too."""
    jp, pp = _ivf_pair()
    try:
        for prompts, metas in _chunks(_trace(40, seed=1), 8):
            jp.serve_batch(prompts, metas)
            jp.pool.drain()
        jpersist.save_snapshot(tmp_path / "j", jp)
        rep = ppersist.restore_policy(pp, tmp_path / "j")
        assert rep["index"] == "warm" and rep["rebuild_thread"] is None
        for k in ("centroids", "codes", "scales", "row_ids"):
            assert np.array_equal(getattr(pp.index.ivf, k).numpy(),
                                  np.asarray(getattr(jp.index.ivf, k))), k
        assert pp.index.ivf.corpus is pp.static.emb      # shared, no copy
        _run_pair(jp, pp, _trace(48, seed=2), 8)
        ppersist.save_snapshot(tmp_path / "p", pp)
        back, _ = _pair({})
        _stop(_)
        try:
            assert jpersist.restore_policy(back, tmp_path / "p",
                                           rebuild="never")["index"] \
                == "warm"
        finally:
            _stop(back)
    finally:
        _stop(jp, pp)


def test_stale_ivf_rebuilds_on_a_joined_thread(tmp_path):
    from repro_torch.core import tiers as T
    jp, pp = _ivf_pair()
    _stop(pp)
    moved = None
    try:
        jp.serve_batch(["define g1", "tell me about m2"])
        jpersist.save_snapshot(tmp_path, jp)
        j2, moved = _pair({})
        _stop(j2)
        moved.static = T.StaticTier(-moved.static.emb, moved.static.cls,
                                    moved.static.answer_ref)
        rep = ppersist.restore_policy(moved, tmp_path)
        assert rep["index"] == "rebuild-background"
        rep["rebuild_thread"].join(60)
        assert not rep["rebuild_thread"].is_alive()
        assert moved.index.describe().startswith("ivf(N=8")
        assert moved.index.ivf.corpus is moved.static.emb
    finally:
        _stop(jp)
        if moved is not None:
            _stop(moved)


def test_segmented_index_rebuilt_by_bulk_load(tmp_path):
    from repro_torch.index.segmented import SegmentedIndex
    jp, pp = _pair({})
    pp.dyn_index = SegmentedIndex(CAP, D, tail_rows=4, compact_every=2,
                                  nprobe=None, n_candidates=CAP,
                                  tail_candidates=CAP, device="cpu")
    try:
        for prompts, metas in _chunks(_trace(40, seed=12), 8):
            jp.serve_batch(prompts, metas)
            jp.pool.drain()
        jpersist.save_snapshot(tmp_path, jp)
        rep = ppersist.restore_policy(pp, tmp_path)
        st = pp.dyn_index_stats()
        assert st["live"] == rep["dyn_live"] == int(jp._valid_np.sum())
        assert st["segments"] == 1 and st["seals"] == 1
        _run_pair(jp, pp, _trace(40, seed=13), 8)
        assert pp.dyn_index_stats()["scans"] > 0
    finally:
        _stop(jp, pp)


def test_bad_snapshots_are_refused(tmp_path):
    jp, pp = _pair({})
    try:
        jp.serve_batch(["define g1", "tell me about m2"])
        path = jpersist.save_snapshot(tmp_path, jp)
        victim = sorted(path.glob("*.npy"))[0]
        raw = bytearray(victim.read_bytes())
        raw[-1] ^= 0xFF
        victim.write_bytes(bytes(raw))
        with pytest.raises(IOError, match="corruption"):
            ppersist.load_snapshot(tmp_path)
        path = ppersist.save_snapshot(tmp_path, pp, step=7)
        (tmp_path / ".tmp_step_00000009").mkdir()      # a torn save
        assert ppersist.latest_snapshot(tmp_path) == 7
        m = json.loads((path / "manifest.json").read_text())
        m["extra"]["format"] = 99
        (path / "manifest.json").write_text(json.dumps(m))
        with pytest.raises(ValueError, match="format"):
            ppersist.load_snapshot(tmp_path)
        with pytest.raises(FileNotFoundError):
            ppersist.load_snapshot(tmp_path / "none")
        small = _pair({})
        _stop(small[0])
        small[1].cfg = type(small[1].cfg)(0.92, 0.9, capacity=CAP + 1)
        ppersist.save_snapshot(tmp_path / "ok", pp)
        with pytest.raises(ValueError, match="capacity"):
            ppersist.restore_policy(small[1], tmp_path / "ok")
        _stop(small[1])
    finally:
        _stop(jp, pp)


# ---------------------------------------------------------------------------
# the launcher's service flags
# ---------------------------------------------------------------------------

FLAGS = ["--device", "cpu", "--l1-capacity", "8", "--volatile-bypass",
         "--ttl-stable", "64", "--rewrite", "--adaptive",
         "--adapt-window", "16", "--adapt-every", "8"]
NEW_PREFIXES = ("so, ", "ok so ", "hmm ")


def test_launcher_snapshot_stdio_crash_and_replay(tmp_path, capsys):
    """Run 1 serves and snapshots at shutdown. A stdio service then
    restores it, serves, snapshots on request, serves more (its
    promotions journaled past the snapshot's cursor) and dies without a
    final snapshot. Run 3 restores that snapshot and replays the tail."""
    from repro_torch.configs import smoke_config
    from repro_torch.core.adaptive import AdaptiveParams
    from repro_torch.core.freshness import FreshnessPolicy
    from repro_torch.launch import serve

    d = tmp_path / "snaps"
    flags = FLAGS + ["--snapshot-dir", str(d)]
    s1 = serve.main(flags + ["--requests", "32"])
    assert s1["errors"] == 0 and "restored_step" not in s1
    assert ppersist.latest_snapshot(d) == 0

    snap = ppersist.load_snapshot(d)
    wal = pwal.PromotionWAL(d / "promo.wal", fsync_every=1)
    svc = serve.build_service(
        smoke_config("qwen3-1.7b"), device="cpu", l1_capacity=8,
        freshness=FreshnessPolicy(volatile_bypass=True, ttl_stable=64,
                                  ttl_unknown=64),
        rewrite=True, wal=wal, snapshot=snap,
        adaptive=AdaptiveParams(window=16, adapt_every=8))
    ops = []
    for k, intent in enumerate(serve.DEMO_INTENTS[:8]):
        ops.append({"op": "serve", "id": k, "cls": k,
                    "prompt": NEW_PREFIXES[0] + intent})
    ops += [{"op": "drain", "id": "d1"}, {"op": "snapshot", "id": "s"},
            {"op": "stats", "id": "st"}]
    ops += [{"op": "serve", "id": 100 + k, "cls": k,
             "prompt": NEW_PREFIXES[1] + intent}
            for k, intent in enumerate(serve.DEMO_INTENTS[:8])]
    ops += [{"op": "drain", "id": "d2"}, {"op": "bogus", "id": "x"}]
    out = io.StringIO()
    try:
        rep = ppersist.restore_policy(svc.policy, snap, rebuild="never")
        assert rep["t"] == snap.extra["t"] > 0
        serve._serve_stdio(svc.policy, d, wal,
                           stdin=io.StringIO("\n".join(
                               json.dumps(o) for o in ops) + "\n"),
                           stdout=out)
    finally:
        svc.stop()              # the process dies: no final snapshot
        wal.close()
    replies = [json.loads(x) for x in out.getvalue().splitlines()]
    assert replies[0]["ready"] and replies[0]["t"] == snap.extra["t"]
    by_id = {r.get("id"): r for r in replies[1:]}
    assert all(by_id[k]["ok"] and by_id[k]["served_by"] in
               ("static", "dynamic", "backend", "l1", "rewritten")
               for k in range(8))
    assert by_id["s"]["snapshot"].endswith("step_00000001")
    assert by_id["st"]["stats"]["requests"] == 8
    assert by_id["d2"]["depth"]["queued"] == 0
    assert by_id["x"]["ok"] is False
    tail = by_id["s"]["wal_seq"]
    with pwal.PromotionWAL(d / "promo.wal") as w:
        assert w.seq > tail

    s3 = serve.main(flags + ["--requests", "8"])
    assert s3["restored_step"] == 1 and s3["wal_replayed"] > 0
    assert s3["wal_skipped"] >= 1 and s3["errors"] == 0
    printed = capsys.readouterr().out
    assert f"wal replay: {s3['wal_replayed']} promotions" in printed
