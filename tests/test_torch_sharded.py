"""Port parity: the sharded serving path on CPU shards.

``make_shard_mesh(S, device="cpu")`` puts S shards on the CPU, so every
sharded lookup, write, policy and launcher path runs here in one
process, with no subprocess, no forced host devices, no process group
and no ``jax.jit`` of a reference. The port is held against:

- itself on one device, bit for bit, on dyadic inputs (unit vectors of
  four +-1/2 entries: every similarity is a multiple of 1/4, exact in
  any summation order), at S in {1, 2, 3, 4, 8}, with ties planted
  across shards, pad rows and a fully invalid dynamic tier;
- JAX's sharded functions at a one-device mesh, in-process;
- a per-shard composite of JAX single-device functions and a numpy
  stable merge, at S = 4;
- the JAX single-device policy on the 500-request trace of
  ``test_torch_policy.py`` (decisions identical, scores within 1e-5,
  rows within 1e-5 of a threshold counted), through ``serve_batch``
  at S in {1, 2, 4}; at four shards also through a ``ShardedIVFIndex``
  at full probe, and its first 100 requests through scalar ``serve``
  (a judge drain after every request).

The reference's own sharded differentials (``test_sharded_serve.py``)
run in subprocesses with eight forced host devices and fail on this JAX
build, so they are not the oracle here.
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import policy as JP
from repro.core import tiers as JT
from repro.core.judge import OracleJudge as JaxOracle
from repro.index import sharded as JS
from repro.kernels.ivf_scan.ops import ivf_search as jax_ivf_search
from repro.kernels.simsearch.ops import cosine_topk as jax_cosine_topk
from repro.launch.mesh import make_shard_mesh as jax_shard_mesh
from repro_torch.core import tiers as T
from repro_torch.core.judge import OracleJudge
from repro_torch.core.policy import KritesPolicy
from repro_torch.embedding.embedder import Embedder
from repro_torch.index import sharded as PS
from repro_torch.index.flat import masked_cosine_topk
from repro_torch.kernels.simsearch.ops import cosine_topk
from repro_torch.launch.mesh import ShardMesh, make_shard_mesh
from repro_torch.launch.serve import (DEMO_INTENTS, build_demo_tier,
                                      demo_requests)
from repro_torch.serving import persist

torch.set_num_threads(1)
SHARDS = (1, 2, 3, 4, 8)
N_STATIC, CAP, D = 1001, 48, 16
TOL = 1e-5
N, BATCH, STATIC_ROWS = 500, 10, 201   # 50 equal batches: one shape
N_SCALAR = 100          # the trace's prefix served one request a call
TAU, SIGMA_MIN, CAPACITY = 0.92, 0.3, 32


@pytest.fixture(scope="module", autouse=True)
def _one_core():
    """Hold every thread of this process to one core while the module
    runs, and give the cores back after. The JAX references here are
    whole-program compiles (the reference policy's ``jax.jit``, its
    ``shard_map``s), whose thread pools would otherwise spread over the
    cores that the other files of a parallel run are timed on."""
    if not hasattr(os, "sched_setaffinity"):
        yield
        return
    cores = os.sched_getaffinity(0)
    one = {min(cores)}

    def pin(cpus) -> None:
        for tid in os.listdir("/proc/self/task"):
            try:
                os.sched_setaffinity(int(tid), cpus)
            except OSError:             # the thread ended meanwhile
                pass
    pin(one)
    try:
        yield
    finally:
        pin(cores)


def _mesh(S: int) -> ShardMesh:
    return make_shard_mesh(S, device="cpu")


def _dyadic(n: int, d: int, seed: int) -> np.ndarray:
    """n unit rows of four +-1/2 entries."""
    rng = np.random.default_rng(seed)
    out = np.zeros((n, d), np.float32)
    for r in range(n):
        cols = rng.choice(d, 4, replace=False)
        out[r, cols] = rng.choice([-0.5, 0.5], 4)
    return out


def _unit(n: int, d: int, seed: int) -> np.ndarray:
    x = np.random.default_rng(seed).standard_normal((n, d))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _np_merge(vals, ids, k):
    """The reference's all_gather + stable top-k, in numpy."""
    v, i = np.concatenate(vals, 1), np.concatenate(ids, 1)
    pos = np.argsort(-v, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(v, pos, 1), np.take_along_axis(i, pos, 1)


def _same(got, want):
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _close(got, want):
    """ids equal, scores within TOL (got: tensors; want: arrays)."""
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=0, atol=TOL)


# ---------------------------------------------------------------------------
# lookups: the port sharded against the port on one device, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", SHARDS)
def test_sharded_static_lookup_is_bit_identical_on_dyadic_rows(S):
    corpus = _dyadic(N_STATIC, D, seed=1)
    last = N_STATIC - 1                 # in the last shard, before pads
    corpus[last] = corpus[5]            # a tie across the first and last
    q = _dyadic(24, D, seed=2)
    q[0], q[1] = corpus[5], corpus[0]   # row 0: the pads copy it
    qt, ct = torch.from_numpy(q), torch.from_numpy(corpus)
    mesh = _mesh(S)
    padded = PS.pad_rows(ct, S)
    assert padded.shape[0] % S == 0 and padded.shape[0] - N_STATIC < S
    got = PS.sharded_cosine_topk(qt, padded, mesh, k=1)
    _same(got, cosine_topk(qt, ct, k=1))
    assert int(got[1].max()) < N_STATIC         # a pad is never the top-1
    assert int(got[1][0, 0]) == 5 and int(got[1][1, 0]) == 0
    # at k > 1 a pad copy may follow row 0, as over the padded rows; a
    # tier of any row count is cut with no pads
    _same(PS.sharded_cosine_topk(qt, padded, mesh, k=4),
          cosine_topk(qt, padded, k=4))
    _same(PS.sharded_cosine_topk(qt, ct, mesh, k=4), cosine_topk(qt, ct, k=4))
    tier = T.make_static_tier(corpus, np.arange(N_STATIC), device="cpu")
    want = T.static_lookup_batch(tier, qt)
    _same(T.static_lookup_batch(tier, qt, mesh=mesh), want)
    _same(PS.sharded_static_lookup(mesh, tier.emb)(qt), want)
    # the policies' layout: the same blocks, the last ones short
    blocks = PS.shard_static_rows(tier.emb, mesh)
    assert sum(b.shape[0] for b in blocks) == N_STATIC
    _same(T.static_lookup_batch(dataclasses.replace(tier, emb=blocks), qt,
                                mesh=mesh), want)


@pytest.mark.parametrize("S", SHARDS)
def test_sharded_masked_lookup_is_bit_identical_on_dyadic_rows(S):
    emb = _dyadic(CAP, D, seed=3)
    emb[CAP - 2] = emb[2]               # a tie across the first and last
    valid = np.random.default_rng(4).random(CAP) < 0.6
    valid[[2, CAP - 2]] = True
    q = _dyadic(24, D, seed=5)
    q[0] = emb[2]
    et, vt, qt = (torch.from_numpy(a) for a in (emb, valid, q))
    mesh = _mesh(S)
    for k in (1, 3):
        want = masked_cosine_topk(qt, et, vt, k=k, corpus_normalized=True)
        _same(PS.sharded_masked_topk(qt, et, vt, mesh, k=k), want)
    assert int(want[1][0, 0]) == 2
    dyn = T.make_dynamic_tier(CAP, D, device="cpu")
    dyn.emb[:], dyn.valid[:] = et, vt
    sharded = PS.shard_dynamic_tier(dyn, mesh)
    assert len(sharded.emb) == S and sharded.rows_per == CAP // S
    got = T.dynamic_lookup_batch(sharded, qt, mesh=mesh)
    want = masked_cosine_topk(qt, et, vt, k=1, corpus_normalized=True)
    _same(got, (want[0][:, 0], want[1][:, 0]))
    # a fully invalid tier: (-inf, 0), and ids in position order for k > 1
    none = torch.zeros(CAP, dtype=torch.bool)
    for k in (1, 3):
        v, i = PS.sharded_masked_topk(qt, et, none, mesh, k=k)
        assert bool((v == float("-inf")).all())
        assert i.tolist() == [list(range(k))] * 24


# ---------------------------------------------------------------------------
# lookups against JAX: in-process at one shard, per-shard composites at four
# ---------------------------------------------------------------------------

def _local_candidates(S, rows, n_per, seed):
    """Candidate ids partitioned by shard: n_per ids of shard s's rows."""
    rng = np.random.default_rng(seed)
    per = rows // S
    return np.concatenate([s * per + rng.permutation(per)[:n_per]
                           for s in range(S)]).astype(np.int32)


@pytest.mark.parametrize("fn", ["cosine", "masked", "local_multi"])
def test_sharded_lookups_match_jax_at_one_shard(fn):
    """JAX's sharded function at ``make_shard_mesh(1)``, in-process,
    against the port at one shard and at four, on random inputs (the
    single-interest local-candidate path is held to JAX's through
    ``retrieval_sharded`` below)."""
    jmesh = jax_shard_mesh(1)
    q = _unit(12, D, seed=6)
    if fn == "cosine":
        c = _unit(1000, D, seed=7)
        want = JS.sharded_cosine_topk(jnp.asarray(q), jnp.asarray(c),
                                      jmesh, k=4)
        for S in (1, 4):
            _close(PS.sharded_cosine_topk(torch.from_numpy(q),
                                          torch.from_numpy(c), _mesh(S),
                                          k=4), want)
    elif fn == "masked":
        e = _unit(CAP, D, seed=8)
        m = np.random.default_rng(9).random(CAP) < 0.5
        want = JS.sharded_masked_topk(jnp.asarray(q), jnp.asarray(e),
                                      jnp.asarray(m), jmesh, k=2)
        for S in (1, 4):
            _close(PS.sharded_masked_topk(torch.from_numpy(q),
                                          torch.from_numpy(e),
                                          torch.from_numpy(m), _mesh(S),
                                          k=2), want)
    else:
        table = np.random.default_rng(10).standard_normal(
            (256, D)).astype(np.float32)
        ids = _local_candidates(4, 256, 40, seed=11)
        u = np.random.default_rng(12).standard_normal(
            (5, 3, D)).astype(np.float32)
        want = JS.sharded_topk_local_candidates(
            jnp.asarray(u), jnp.asarray(table), jnp.asarray(ids), jmesh,
            k=7)
        for S in (1, 4):
            _close(PS.sharded_topk_local_candidates(
                torch.from_numpy(u), torch.from_numpy(table),
                torch.from_numpy(ids), _mesh(S), k=7), want)
        # the same candidates through the unpartitioned scorer
        _close(PS.sharded_topk_scores(torch.from_numpy(u),
                                      torch.from_numpy(table[ids]),
                                      torch.from_numpy(ids), _mesh(4),
                                      k=7), want)


@pytest.mark.parametrize("fn", ["cosine", "masked", "ivf"])
def test_sharded_lookups_match_a_composite_of_jax_single_device(fn):
    """At four shards: JAX's single-device function on each shard's
    slice, global ids, then a numpy stable merge."""
    S, k = 4, 3
    q = _unit(16, D, seed=13)
    if fn == "masked":
        e = _unit(CAP, D, seed=14)
        m = np.random.default_rng(15).random(CAP) < 0.5
        per = CAP // S
        vals, ids = [], []
        for s in range(S):
            sims = q @ e[s * per:(s + 1) * per].T
            sims = np.where(m[None, s * per:(s + 1) * per], sims, -np.inf)
            pos = np.argsort(-sims, axis=1, kind="stable")[:, :k]
            vals.append(np.take_along_axis(sims, pos, 1))
            ids.append(pos + s * per)
        _close(PS.sharded_masked_topk(torch.from_numpy(q),
                                      torch.from_numpy(e),
                                      torch.from_numpy(m), _mesh(S), k=k),
               _np_merge(vals, ids, k))
        return
    corpus = _unit(N_STATIC, D, seed=16)
    padded = PS.pad_rows(corpus, S)
    per = padded.shape[0] // S
    if fn == "cosine":
        vals, ids = [], []
        for s in range(S):
            v, i = jax_cosine_topk(jnp.asarray(q),
                                   jnp.asarray(padded[s * per:(s + 1) * per]),
                                   k=k)
            vals.append(np.asarray(v))
            ids.append(np.asarray(i) + s * per)
        _close(PS.sharded_cosine_topk(torch.from_numpy(q),
                                      torch.from_numpy(padded), _mesh(S),
                                      k=k), _np_merge(vals, ids, k))
        return
    # ivf: the reference's stacked layout, carried over a shard at a time
    lay = JS.build_sharded_ivf(padded, S, n_clusters=4)
    arrs = [np.asarray(a) for a in (lay.centroids, lay.codes, lay.scales,
                                    lay.row_ids, lay.corpus)]
    index = PS.ShardedIVFIndex(corpus, _mesh(S), nprobe=2, n_candidates=16,
                               sivf=PS.sharded_ivf_from_numpy(*arrs,
                                                              _mesh(S)))
    assert index.describe().startswith(f"sharded-ivf(N={N_STATIC}, shards=4")
    vals, ids = [], []
    for s in range(S):
        rid = np.where(arrs[3][s] + s * per >= N_STATIC, -1, arrs[3][s])
        v, i = jax_ivf_search(jnp.asarray(q), arrs[4][s], arrs[0][s],
                              arrs[1][s], arrs[2][s], jnp.asarray(rid),
                              k=k, nprobe=2, n_candidates=16)
        i = np.asarray(i)
        vals.append(np.asarray(v))
        ids.append(np.where(i >= 0, i + s * per, -1))
    want = _np_merge(vals, ids, k)
    got = index.topk(torch.from_numpy(q), k=k)
    _close(got, want)
    assert int(got[1].max()) < N_STATIC
    v, i = PS.sharded_ivf_lookup(_mesh(S), index.sivf, nprobe=2,
                                 n_candidates=16)(torch.from_numpy(q))
    _same((v, i), (got[0][:, 0], got[1][:, 0]))


# ---------------------------------------------------------------------------
# writes: owner-routed, equal to the single-device scatters
# ---------------------------------------------------------------------------

def _tier_arrays(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"emb": _unit(CAP, D, seed), "cls": rng.integers(0, 9, CAP),
            "answer_ref": rng.integers(-2, 20, CAP),
            "static_origin": rng.random(CAP) < 0.5,
            "valid": rng.random(CAP) < 0.5,
            "last_used": rng.integers(0, 50, CAP),
            "written_at": rng.integers(0, 50, CAP),
            "expires_at": rng.integers(0, 2, CAP) * 90}


def _port_columns(tier) -> dict:
    return {f: persist._host_column(tier, f) for f in _FIELDS}


_FIELDS = [f.name for f in dataclasses.fields(T.DynamicTier)]


_INSIDE = np.array([47, 0, 13, 25, 36, 5, 30, 18])    # every shard's
_OUTSIDE = np.array([-1, -13, CAP, 2 * CAP])           # no shard's
_SLOTS = np.concatenate([_INSIDE, _OUTSIDE])
_ROWS = np.arange(len(_SLOTS)) % 6
_TS = 100 + np.arange(len(_SLOTS))
_CLS = 7 + np.arange(len(_SLOTS))
_EXPS = np.where(np.arange(len(_SLOTS)) % 2, 0, 500 + _TS)
_WRITES = ((31, 200), (-1, 201), (CAP, 202), (3, 203))
_TOUCH = np.concatenate([_INSIDE[::2], _OUTSIDE])
_NOWS = 300 + np.arange(len(_TOUCH))


@pytest.fixture(scope="module")
def jax_writes():
    """JAX's single-device scatters on the owned slots, once: a bulk
    insert, single writes and an LRU touch. JAX's single-device scatter
    wraps a negative slot, so only owned slots go to it; the reference's
    sharded twins drop the others."""
    jaxt = JT.DynamicTier(**{f: jnp.asarray(a).astype(
        getattr(JT.make_dynamic_tier(1, D), f).dtype)
        for f, a in _tier_arrays(17).items()})
    n = len(_INSIDE)
    jaxt = JP._bulk_insert(jaxt, jnp.asarray(_unit(6, D, seed=18)),
                           jnp.asarray(_INSIDE), jnp.asarray(_ROWS[:n]),
                           jnp.asarray(_TS[:n]), jnp.asarray(_CLS[:n]),
                           jnp.asarray(_EXPS[:n]))
    for slot, now in _WRITES:
        if 0 <= slot < CAP:
            q = jnp.asarray(_unit(1, D, slot % 97)[0])
            jaxt = JT._write(jaxt, slot, q, jnp.int32(4), jnp.int32(11),
                             jnp.asarray(True), now, last_used=now + 1,
                             expires=now + 9)
    k = len(_INSIDE[::2])
    touched = JT.touch_many(jaxt, jnp.asarray(_TOUCH[:k]),
                            jnp.asarray(_NOWS[:k]))
    return {f: np.asarray(getattr(touched, f)) for f in _FIELDS}


@pytest.mark.parametrize("S", (1, 3, 4, 8))
def test_sharded_writes_match_jax_single_device(S, jax_writes):
    """Bulk insert, single writes and LRU touches over slots of every
    shard, negative and out-of-range ones among them: the port's
    shard-routed twins leave the tier equal, field for field, to JAX's
    single-device scatters on the owned slots (the others are no
    shard's and are dropped, as the reference's twins drop them)."""
    mesh = _mesh(S)
    like = T.make_dynamic_tier(1, D, "cpu")
    dyn = T.DynamicTier(**{f: torch.as_tensor(a).to(getattr(like, f).dtype)
                           for f, a in _tier_arrays(17).items()})
    port = PS.shard_dynamic_tier(dyn, mesh)
    PS.sharded_bulk_insert(port, torch.from_numpy(_unit(6, D, seed=18)),
                           _SLOTS, _ROWS, _TS, _CLS, mesh, exps=_EXPS)
    for slot, now in _WRITES:
        q = torch.from_numpy(_unit(1, D, slot % 97)[0])
        PS.sharded_dyn_write(port, slot, q, 4, 11, True, now, mesh,
                             last_used=now + 1, expires=now + 9)
    PS.sharded_touch_many(port, _TOUCH, _NOWS, mesh)
    got = _port_columns(port)
    for f in _FIELDS:
        np.testing.assert_array_equal(got[f], jax_writes[f], err_msg=f)
    # each shard's rows are views: the block of the whole tier it owns
    per = CAP // S
    for s in range(S):
        assert torch.equal(port.cls[s], dyn.cls[s * per:(s + 1) * per])
    PS.sharded_invalidate(port, [47, -1, 0], mesh)
    assert not bool(dyn.valid[47]) and not bool(dyn.valid[0])
    assert int(dyn.expires_at[0]) == 0


# ---------------------------------------------------------------------------
# the policy: the 500-request trace against the JAX single-device policy
# ---------------------------------------------------------------------------

def _backend_batch(ps):
    return [f"gen({p})" for p in ps]


def _near(x: float) -> bool:
    return any(abs(x - t) <= TOL for t in (TAU, SIGMA_MIN))


class _Memo:
    """An embedder that keeps each prompt's vector: every run of the
    trace embeds the same prompts."""

    def __init__(self, emb):
        self.emb, self.memo = emb, {}

    def batch(self, texts):
        todo = [t for t in dict.fromkeys(texts) if t not in self.memo]
        if todo:
            self.memo.update(zip(todo, self.emb.batch(todo)))
        return np.stack([self.memo[t] for t in texts])

    def __call__(self, text):
        return self.batch([text])[0]


@pytest.fixture(scope="module")
def demo():
    """The trace, the embedder and the static tier. Both packages'
    policies embed with the port's embedder (held to JAX's in
    ``test_torch_policy.py``), so the lookups see the same vectors."""
    pemb = _Memo(Embedder(d_out=64, device="cpu"))
    rows = pemb.batch(DEMO_INTENTS)
    answers = [f"[curated] {p}" for p in DEMO_INTENTS]
    ptier, answers, texts, _ = build_demo_tier(
        rows, answers, static_rows=STATIC_ROWS, texts=DEMO_INTENTS,
        device="cpu")
    jtier = JT.make_static_tier(jnp.asarray(ptier.emb.numpy()),
                                jnp.arange(STATIC_ROWS))
    return dict(pemb=pemb, ptier=ptier, jtier=jtier,
                answers=answers, texts=texts, trace=demo_requests(N))


def _kw(demo):
    return dict(backend_fn=lambda p: f"gen({p})", d=64, n_workers=1,
                backend_batch_fn=_backend_batch,
                static_texts=demo["texts"])


def _decisions(pol, trace, scalar: bool):
    """Serve the trace (batches of 8, or one request at a time), the
    judge pool drained after each call; per row (served_by, answer,
    static_origin, similarity), and the mirrors after each call."""
    out, states = [], []
    step = 1 if scalar else BATCH
    for b0 in range(0, len(trace), step):
        chunk = trace[b0:b0 + step]
        if scalar:
            res = [pol.serve(p, m) for p, m in chunk]
        else:
            res = pol.serve_batch([p for p, _ in chunk],
                                  [m for _, m in chunk])
        pol.pool.drain()
        out += [(r.served_by, r.answer, r.static_origin, r.similarity)
                for r in res]
        if b0 % 40 == 0 or b0 + step >= len(trace):
            states.append((b0, {f: getattr(pol, f).copy() for f in (
                "_valid_np", "_static_origin_np", "_written_at_np",
                "_last_used_np", "_expires_np")}, list(pol.dyn_answers)))
    return out, states, pol.stats()


@pytest.fixture(scope="module")
def jax_ref(demo):
    """The JAX single-device policy's decisions, once per module."""
    refs = {}
    for mode in ("batch", "scalar"):
        trace = demo["trace"][:N_SCALAR] if mode == "scalar" \
            else demo["trace"]
        jpol = JP.KritesPolicy(JT.CacheConfig(TAU, TAU, sigma_min=SIGMA_MIN,
                                              capacity=CAPACITY),
                               demo["jtier"], demo["answers"], demo["pemb"],
                               judge_fn=JaxOracle(), **_kw(demo))
        try:
            refs[mode] = _decisions(jpol, trace, mode == "scalar")
        finally:
            jpol.pool.stop()
    return refs


@pytest.mark.parametrize("S,mode", [(1, "batch"), (2, "batch"), (4, "batch"),
                                    (4, "scalar"), (4, "ivf")])
def test_sharded_policy_matches_jax_single_device(S, mode, demo, jax_ref,
                                                  capsys):
    mesh = _mesh(S)
    index = None
    if mode == "ivf":
        # full probe with every shard row a candidate: the exact rerank
        # then serves flat search's pairs on any shard layout
        index = PS.ShardedIVFIndex(demo["ptier"].emb, mesh, nprobe=64,
                                   n_candidates=256, n_clusters=4)
    pol = KritesPolicy(T.CacheConfig(TAU, TAU, sigma_min=SIGMA_MIN,
                                     capacity=CAPACITY),
                       demo["ptier"], demo["answers"], demo["pemb"],
                       judge_fn=OracleJudge(), mesh=mesh, index=index,
                       **_kw(demo))
    try:
        assert pol.device == torch.device("cpu") and pol.mesh is mesh
        trace = demo["trace"][:N_SCALAR] if mode == "scalar" \
            else demo["trace"]
        got, states, stats = _decisions(pol, trace, mode == "scalar")
        shard = pol.shard_stats()
    finally:
        pol.pool.stop()
    want, wstates, wstats = jax_ref["batch" if mode == "ivf" else mode]
    assert len(got) == len(want) == len(trace)
    near = 0
    for row, (a, b) in enumerate(zip(want, got)):
        near += _near(a[3])
        assert a[:3] == b[:3], row
        assert a[3] == b[3] or abs(a[3] - b[3]) <= TOL, row
    for (b0, mw, aw), (_, mg, ag) in zip(wstates, states):
        for f in mw:
            assert np.array_equal(mw[f], mg[f]), (b0, f)
        assert aw == ag, b0
    for k in ("static_hit_rate", "dynamic_hit_rate", "backend_rate",
              "static_origin_rate", "judged", "approved", "judge_deduped"):
        assert wstats[k] == stats[k], k
    assert stats["approved"] > 0 and stats["dynamic_hit_rate"] > 0
    assert shard["shards"] == S and len(shard["shard_occupancy"]) == S
    assert sum(shard["shard_occupancy"]) == int(states[-1][1]
                                                ["_valid_np"].sum())
    with capsys.disabled():
        print(f"\n[sharded policy S={S} {mode}] rows within {TOL} of a "
              f"threshold: {near} of {len(trace)}")


def test_policy_mesh_refusals_and_telemetry(demo):
    tier = demo["ptier"]
    kw = dict(embed_fn=demo["pemb"], backend_fn=None,
              judge_fn=OracleJudge(), d=64, n_workers=0)
    cfg = T.CacheConfig(TAU, TAU, capacity=CAPACITY)
    with pytest.raises(ValueError, match="dyn_index \\+ mesh"):
        KritesPolicy(cfg, tier, demo["answers"], mesh=_mesh(2),
                     dyn_index="segmented", **kw)
    with pytest.raises(ValueError, match="does not split"):
        KritesPolicy(cfg, tier, demo["answers"], mesh=_mesh(3), **kw)
    with pytest.raises(ValueError, match="fused= replaces"):
        KritesPolicy(cfg, tier, demo["answers"], mesh=_mesh(2),
                     fused=object(), **kw)
    with pytest.raises(ValueError, match="the mesh's axis is 'model'"):
        KritesPolicy(cfg, tier, demo["answers"], mesh=_mesh(2),
                     shard_axis="data", **kw)
    pol = KritesPolicy(cfg, tier, demo["answers"], mesh=_mesh(4), **kw)
    try:
        assert pol.describe_index() == \
            f"sharded-flat(S={STATIC_ROWS}, shards=4)"
        assert pol.describe_dyn_index() == \
            f"sharded-masked(C={CAPACITY}, shards=4)"
        assert pol.shard_stats() == {"shards": 4,
                                     "shard_occupancy": [0, 0, 0, 0]}
        # 201 rows in blocks of 51, no pad rows: views of the tier on the
        # one device, hashed as the tier is
        parts = pol.static.emb
        assert [p.shape[0] for p in parts] == [51, 51, 51, 48]
        ptr = tier.emb.untyped_storage().data_ptr()
        assert all(p.untyped_storage().data_ptr() == ptr for p in parts)
        assert persist.state_hash(parts) == persist.state_hash(tier.emb)
        with pytest.raises(TypeError):
            pol.dyn.valid[0] = False        # a sharded field is a tuple
    finally:
        pol.pool.stop()
    # a mesh over two devices (two names of the CPU here) keeps a copy a
    # shard and no view of the caller's tier
    two = ShardMesh("model", (torch.device("cpu"), torch.device("cpu", 0)))
    pol = KritesPolicy(cfg, tier, demo["answers"], mesh=two, **kw)
    try:
        parts = pol.static.emb
        assert [p.shape[0] for p in parts] == [101, 100]
        assert not any(p.untyped_storage().data_ptr() == ptr for p in parts)
        assert torch.equal(torch.cat(parts), tier.emb)
        assert all(f[0].untyped_storage().data_ptr()
                   != f[1].untyped_storage().data_ptr()
                   for f in (pol.dyn.emb, pol.dyn.valid))
    finally:
        pol.pool.stop()
    mesh = _mesh(3)
    assert mesh.shape == {"model": 3} and mesh.axis == "model"
    assert mesh.devices == (torch.device("cpu"),) * 3
    with pytest.raises(ValueError):
        make_shard_mesh(0, device="cpu")
    with pytest.raises(ValueError, match="pad them first"):
        PS.shard_rows(torch.zeros(5, 2), mesh)


# ---------------------------------------------------------------------------
# persist, launcher, live workload, retrieval
# ---------------------------------------------------------------------------

def _tier_hashes(dyn) -> dict:
    if isinstance(dyn, JT.DynamicTier):
        return {f: persist.state_hash(np.asarray(getattr(dyn, f)))
                for f in _FIELDS}
    return {f: persist.state_hash(persist._host_column(dyn, f))
            for f in _FIELDS}


def test_sharded_snapshot_restores_into_shards_and_into_jax(demo, tmp_path):
    """A 4-shard port policy's snapshot restores into a fresh 4-shard
    port policy and into the JAX single-device policy: every tier
    column's hash equal, and the next 50 decisions identical."""
    from repro.serving import persist as jpersist

    def port():
        return KritesPolicy(T.CacheConfig(TAU, TAU, sigma_min=SIGMA_MIN,
                                          capacity=CAPACITY),
                            demo["ptier"], demo["answers"], demo["pemb"],
                            judge_fn=OracleJudge(), mesh=_mesh(4),
                            **_kw(demo))
    live, again = port(), port()
    jpol = JP.KritesPolicy(JT.CacheConfig(TAU, TAU, sigma_min=SIGMA_MIN,
                                          capacity=CAPACITY),
                           demo["jtier"], demo["answers"], demo["pemb"],
                           judge_fn=JaxOracle(), **_kw(demo))
    try:
        _decisions(live, demo["trace"][:100], scalar=False)
        persist.save_snapshot(tmp_path, live)
        rep = persist.restore_policy(again, tmp_path)
        jrep = jpersist.restore_policy(jpol, tmp_path)
        assert rep["dyn_live"] == jrep["dyn_live"] > 0
        assert rep["index"] == "none" and isinstance(
            again.dyn, PS.ShardedDynamicTier)
        want = _tier_hashes(live.dyn)
        assert _tier_hashes(again.dyn) == want == _tier_hashes(jpol.dyn)
        nxt = demo["trace"][100:150]
        outs = [_decisions(p, nxt, scalar=False)[0]
                for p in (live, again, jpol)]
        for a, b, c in zip(*outs):
            assert a[:3] == b[:3] == c[:3]
            assert abs(a[3] - c[3]) <= TOL and a[3] == b[3]
    finally:
        for p in (live, again, jpol):
            p.pool.stop()


def test_launcher_shards_serve_the_decisions_of_one_device(capsys):
    """``--device cpu --shards 4`` serves with 0 errors; the wired stack
    it builds (behind the stub backend) decides every request as the
    one-device stack does."""
    from repro_torch.launch import serve
    s = serve.main(["--device", "cpu", "--shards", "4", "--requests",
                    "16", "--dyn-index", "segmented"])
    out = capsys.readouterr().out
    assert "shards: 4 on cpu, cpu, cpu, cpu" in out
    assert "the shards serve the dynamic tier through the row-sharded" in out
    assert s["errors"] == 0 and s["shards"] == 4
    reqs = demo_requests(50, seed=3)
    runs = []
    for shards in (1, 4):
        svc = serve.build_service(None, device="cpu", capacity=32,
                                  shards=shards)
        try:
            runs.append(_decisions(svc.policy, reqs, scalar=False)[0])
            assert svc.policy.describe_index().startswith(
                "sharded-flat" if shards > 1 else "flat-exact")
        finally:
            svc.stop()
    assert runs[0] == runs[1]
    assert {"static", "dynamic", "backend"} <= {r[0] for r in runs[0]}


def test_cache_workload_run_live_on_cpu_shards(capsys):
    from repro_torch.launch import cache_workload
    one = cache_workload.run_live(n_requests=96, shards=1, device="cpu")
    four = cache_workload.run_live(n_requests=96, shards=4, device="cpu",
                                   dyn_index="segmented")
    out = capsys.readouterr().out
    assert "the shards serve the dynamic tier through the row-sharded" in out
    assert one["errors"] == four["errors"] == 0
    assert four["shards"] == 4 and "shards" not in one
    # the static decisions do not depend on batch composition or timing
    assert one["static_hit_rate"] == four["static_hit_rate"] > 0
    with pytest.raises(SystemExit):
        cache_workload.main(["--device", "cpu"])
    assert "queue 4" in capsys.readouterr().err


def test_retrieval_sharded_matches_jax_and_one_device():
    """Wide&Deep retrieval over range-partitioned candidates: JAX's
    ``retrieval_sharded`` at one shard, the port's at one and four, and
    the port's unsharded ``retrieval`` on the same candidates."""
    import jax

    from repro.configs import smoke_config as jax_smoke_config
    from repro.models import recsys as JR
    from repro_torch.configs import smoke_config
    from repro_torch.data.recsys_data import recsys_batches
    from repro_torch.models import recsys as PR
    jcfg, cfg = jax_smoke_config("wide-deep"), smoke_config("wide-deep")
    # the port's random weights (the JAX package's tree layout) in both
    params = PR.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    tree = jax.tree.map(lambda t: t.numpy(), params)
    batch = next(recsys_batches(cfg, 6, seed=4))
    del batch["label"]
    rows = params["item_emb"].shape[0]
    batch["cand_ids"] = _local_candidates(4, rows, 64, seed=19)
    k = 10
    jv, ji = JR.retrieval_sharded(
        jcfg, jax.tree.map(jnp.asarray, tree),
        {n: jnp.asarray(v) for n, v in batch.items()}, jax_shard_mesh(1),
        k=k)
    tb = PR.batch_from_numpy(batch, "cpu")
    single = PR.retrieval(cfg, params, tb, k=k)
    for S in (1, 4):
        got = PR.retrieval_sharded(cfg, params, tb, _mesh(S), k=k)
        _same(got, single)
        _close(got, (np.asarray(jv), np.asarray(ji)))
