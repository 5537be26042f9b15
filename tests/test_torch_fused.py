"""Port parity: the fused two-tier lookup, and the serving policy over
the IVF, segmented and fused paths.

``fused_serve_probe`` / ``fused_serve`` are held against the JAX oracle
``fused_serve_ref`` and the Pallas kernel in interpret mode on the FUSED
cases of ``test_kernel_conformance.py`` (approximate scores within 1e-6,
candidate ids identical except at reference near-ties, which are
counted; served scores within 1e-5). Then one trace goes through the JAX
and the port ``KritesPolicy.serve_batch`` with (i) an ``IVFIndex`` on a
layout built by the JAX package and carried over, plus a full-recall
segmented dynamic index, and (ii) ``FusedServe`` on the same layout.
Per-row served_by, answer, static_origin and promotions must be
identical and scores within 1e-5; rows whose reference score lies within
1e-5 of a threshold are counted and reported. Inputs come from numpy
seeds."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.judge import OracleJudge as JaxOracle
from repro.core.policy import KritesPolicy as JaxKrites
from repro.core.tiers import CacheConfig as JaxConfig
from repro.core.tiers import make_static_tier as jax_static_tier
from repro.embedding.embedder import Embedder as JaxEmbedder
from repro.index.ivf import IVFIndex as JaxIVFIndex
from repro.index.ivf import build_ivf as jax_build_ivf
from repro.index.segmented import SegmentedIndex as JaxSegmentedIndex
from repro.kernels.fused_serve import FusedServe as JaxFusedServe
from repro.kernels.fused_serve.ops import fused_serve as jax_fused_serve
from repro.kernels.fused_serve.ops import \
    fused_serve_probe as jax_fused_probe
from repro.kernels.fused_serve.ops import pack_dyn_tiles as jax_pack
from repro.kernels.fused_serve.ref import dyn_scan_ref as jax_dyn_scan_ref
from repro.kernels.fused_serve.ref import fused_serve_ref as jax_fused_ref
from repro_torch.core import tiers as PT
from repro_torch.core.judge import OracleJudge
from repro_torch.core.policy import KritesPolicy
from repro_torch.core.tiers import CacheConfig
from repro_torch.embedding.embedder import Embedder
from repro_torch.index.ivf import IVFIndex, ivf_from_numpy
from repro_torch.index.segmented import SegmentedIndex
from repro_torch.kernels.fused_serve import (FusedServe, fused_serve,
                                             fused_serve_probe,
                                             pack_dyn_tiles)
from repro_torch.kernels.fused_serve.ref import (fused_serve_ref,
                                                 tile_scan_ref)
from repro_torch.launch.serve import (DEMO_INTENTS, build_demo_tier,
                                      demo_requests)
from test_torch_ivf import _assert_candidates

torch.set_num_threads(1)

#  N,  d, B,  K, nprobe,  C, cap, Cd, valid_frac: the FUSED cases and
# edge cases of test_kernel_conformance.py
CASES = [
    (512, 16, 3, 8, 3, 8, 64, 8, 0.6),
    (2000, 32, 7, 32, 6, 24, 256, 16, 0.9),
    (640, 48, 1, 12, 12, 48, 100, 16, 0.5),   # full probe
    (300, 8, 5, 4, 2, 4, 24, 4, 0.3),         # odd capacity
    (64, 8, 0, 4, 2, 4, 32, 8, 0.5),          # empty batch
    (64, 8, 3, 4, 2, 4, 32, 8, 0.0),          # all-invalid dyn
    (1, 8, 2, 1, 1, 1, 4, 8, 1.0),            # 1-row corpus, Cd > cap
    (4096, 32, 5, 64, 10, 48, 1200, 24, 0.6),  # nprobe + 3 tiles > 8
]
INTERPRET = (CASES[0], CASES[5])   # the Pallas kernel: ~1 s a case


@functools.lru_cache(maxsize=None)
def _make(case):
    N, d, B, K, _, _, cap_dyn, _, valid_frac = case
    rng = np.random.default_rng(11 * N + d)
    centers = rng.standard_normal((max(2, K), d))
    rows = (centers[rng.integers(0, max(2, K), N)]
            + 0.3 * rng.standard_normal((N, d))).astype(np.float32)
    q = (rows[rng.integers(0, N, B)]
         + 0.05 * rng.standard_normal((B, d))).astype(np.float32)
    jivf = jax_build_ivf(rows, n_clusters=K, iters=3)
    dyn = np.zeros((cap_dyn, d), np.float32)
    valid = np.zeros(cap_dyn, bool)
    n_live = int(round(valid_frac * cap_dyn))
    if n_live:
        live = rng.choice(cap_dyn, n_live, replace=False)
        e = rng.standard_normal((n_live, d)).astype(np.float32)
        dyn[live] = e / np.linalg.norm(e, axis=1, keepdims=True)
        valid[live] = True
    if B > 1 and n_live:        # a query that is a live tier row
        q[1] = dyn[live[0]]
    return q, jivf, dyn, valid


def _port_args(case):
    q, jivf, dyn, valid = _make(case)
    ivf = ivf_from_numpy(jivf.centroids, jivf.codes, jivf.scales,
                         jivf.row_ids, jivf.corpus, device="cpu")
    return (torch.from_numpy(q), ivf, torch.from_numpy(dyn),
            torch.from_numpy(valid))


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_fused_probe_matches_jax_ref_and_interpret(case):
    _, _, B, _, nprobe, C, cap_dyn, Cd, _ = case
    q, jivf, dyn, valid = _make(case)
    qt, ivf, dt, vt = _port_args(case)
    jargs = (jnp.asarray(q), jivf.centroids, jivf.codes, jivf.scales,
             jivf.row_ids, jnp.asarray(dyn), jnp.asarray(valid))
    wants = [jax_fused_ref(*jargs, nprobe, C, Cd)]
    if case in INTERPRET:
        wants.append(jax_fused_probe(*jargs, nprobe=nprobe, n_candidates=C,
                                     n_dyn_candidates=Cd,
                                     force="interpret"))
    pargs = (qt, ivf.centroids, ivf.codes, ivf.scales, ivf.row_ids, dt, vt)
    gots = [fused_serve_probe(*pargs, nprobe=nprobe, n_candidates=C,
                              n_dyn_candidates=Cd),
            fused_serve_ref(*pargs, nprobe, C, Cd)]
    near = 0
    for want in wants:
        for got in gots:
            near += _assert_candidates(got[:2], want[:2])
            near += _assert_candidates(got[2:], want[2:])
    assert gots[0][2].shape == (B, min(Cd, cap_dyn))
    assert near == 0, f"{near} candidate positions differ at near-ties"


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_fused_serve_matches_jax(case):
    _, _, B, _, nprobe, C, _, Cd, frac = case
    q, jivf, dyn, valid = _make(case)
    qt, ivf, dt, vt = _port_args(case)
    want = jax_fused_serve(jnp.asarray(q), jivf.corpus, jivf.centroids,
                           jivf.codes, jivf.scales, jivf.row_ids,
                           jnp.asarray(dyn), jnp.asarray(valid),
                           nprobe=nprobe, n_candidates=C,
                           n_dyn_candidates=Cd)
    got = fused_serve(qt, ivf.corpus, ivf.centroids, ivf.codes, ivf.scales,
                      ivf.row_ids, dt, vt, nprobe=nprobe, n_candidates=C,
                      n_dyn_candidates=Cd)
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape == (B,)
        if g.dtype == np.int32:
            assert np.array_equal(g, w)
        else:
            assert np.array_equal(np.isneginf(g), np.isneginf(w))
            np.testing.assert_allclose(g[np.isfinite(g)], w[np.isfinite(w)],
                                       rtol=0, atol=1e-5)
    if frac == 0.0:             # all-invalid tier: (-inf, 0) per row
        assert torch.isneginf(got[2]).all() and (got[3] == 0).all()


def test_pack_dyn_tiles_matches_jax():
    """The packed tiles equal the JAX package's, and the kernel-signature
    plain version over several padded tiles equals ``dyn_scan_ref``."""
    rng = np.random.default_rng(6)
    dyn = rng.standard_normal((100, 16)).astype(np.float32)
    dyn /= np.linalg.norm(dyn, axis=1, keepdims=True)
    valid = rng.random(100) < 0.5
    q = rng.standard_normal((5, 16)).astype(np.float32)
    qn = torch.from_numpy(q / np.linalg.norm(q, axis=1, keepdims=True))
    want = jax_dyn_scan_ref(jnp.asarray(q), jnp.asarray(dyn),
                            jnp.asarray(valid), 12)
    for tile in (32, 100, 128):
        t, i = pack_dyn_tiles(torch.from_numpy(dyn),
                              torch.from_numpy(valid), tile)
        jt, ji = jax_pack(jnp.asarray(dyn), jnp.asarray(valid), tile)
        assert t.dtype == torch.bfloat16 and i.dtype == torch.int32
        assert np.array_equal(t.float().numpy(),
                              np.asarray(jt.astype(jnp.float32)))
        assert np.array_equal(i.numpy(), np.asarray(ji))
        assert _assert_candidates(tile_scan_ref(qn, t, i, 12), want) == 0


def test_serve_lookup_batch_equals_dispatched_lookups():
    """Full probe, corpus-wide budgets: the fused lookup equals the IVF
    static lookup and the flat masked dynamic lookup exactly."""
    case = CASES[1]
    qt, ivf, dt, vt = _port_args(case)
    K, cap, d = ivf.codes.shape
    qn = qt / qt.norm(dim=1, keepdim=True)
    stier = PT.make_static_tier(ivf.corpus, torch.zeros(ivf.corpus.shape[0]),
                                device="cpu")
    dtier = PT.make_dynamic_tier(dt.shape[0], d, device="cpu")
    dtier.emb.copy_(dt)
    dtier.valid.copy_(vt)
    fused = FusedServe(ivf, nprobe=K, n_candidates=K * cap,
                       n_dyn_candidates=dt.shape[0])
    ss, hi, sd, j = PT.serve_lookup_batch(stier, dtier, qn, fused)
    s2, h2 = PT.static_lookup_batch(stier, qn, index=IVFIndex(
        ivf, nprobe=K, n_candidates=K * cap))
    s3, j3 = PT.dynamic_lookup_batch(dtier, qn)
    assert torch.equal(hi, h2) and torch.equal(j, j3)
    assert torch.allclose(ss, s2, rtol=0, atol=1e-6)
    assert torch.allclose(sd, s3, rtol=0, atol=1e-6)
    assert fused.describe() == JaxFusedServe(
        ivf, nprobe=K, n_candidates=K * cap,
        n_dyn_candidates=dt.shape[0]).describe()


# ---------------------------------------------------------------------------
# policy differential: JAX vs port over the IVF + segmented and fused paths
# ---------------------------------------------------------------------------

N, BATCH, STATIC_ROWS = 160, 8, 200
TAU, SIGMA_MIN, CAPACITY = 0.92, 0.3, 32


def _backend_batch(ps):
    return [f"gen({p})" for p in ps]


@pytest.mark.parametrize("path", ["ivf+segmented", "fused"])
def test_krites_serve_batch_matches_jax(path):
    jemb = JaxEmbedder(d_out=64)
    pemb = Embedder(d_out=64, w1=np.asarray(jemb.w1),
                    w2=np.asarray(jemb.w2), device="cpu")
    rows = np.asarray(jemb.batch(DEMO_INTENTS), np.float32)
    answers = [f"[curated] {p}" for p in DEMO_INTENTS]
    ptier, answers, texts, _ = build_demo_tier(
        rows, answers, static_rows=STATIC_ROWS, texts=DEMO_INTENTS,
        device="cpu")
    pad = np.random.default_rng(7).normal(
        size=(STATIC_ROWS - len(DEMO_INTENTS), 64)).astype(np.float32)
    jtier = jax_static_tier(jnp.asarray(np.concatenate([rows, pad])),
                            jnp.arange(STATIC_ROWS))
    jivf = jax_build_ivf(np.asarray(jtier.emb), n_clusters=8, iters=4,
                         corpus_normalized=True)
    ivf = ivf_from_numpy(jivf.centroids, jivf.codes, jivf.scales,
                         jivf.row_ids, jivf.corpus, device="cpu")
    seg = dict(tail_rows=16, nprobe=None, n_candidates=4 * CAPACITY,
               tail_candidates=16, compact_every=2)
    if path == "fused":
        jopts = dict(fused=JaxFusedServe(jivf, nprobe=4, n_candidates=16,
                                         n_dyn_candidates=16))
        popts = dict(fused=FusedServe(ivf, nprobe=4, n_candidates=16,
                                      n_dyn_candidates=16))
    else:
        jopts = dict(index=JaxIVFIndex(jivf, nprobe=4, n_candidates=16),
                     dyn_index=JaxSegmentedIndex(CAPACITY, 64, **seg))
        popts = dict(index=IVFIndex(ivf, nprobe=4, n_candidates=16),
                     dyn_index=SegmentedIndex(CAPACITY, 64, device="cpu",
                                              **seg))
    kw = dict(backend_fn=lambda p: f"gen({p})", d=64, n_workers=1,
              backend_batch_fn=_backend_batch, static_texts=texts)
    jpol = JaxKrites(JaxConfig(TAU, TAU, sigma_min=SIGMA_MIN,
                               capacity=CAPACITY),
                     jtier, answers, jemb, judge_fn=JaxOracle(), **kw,
                     **jopts)
    ppol = KritesPolicy(CacheConfig(TAU, TAU, sigma_min=SIGMA_MIN,
                                    capacity=CAPACITY),
                        ptier, answers, pemb, judge_fn=OracleJudge(),
                        device="cpu", **kw, **popts)
    trace = demo_requests(N, seed=3)
    near = 0
    try:
        for b0 in range(0, N, BATCH):
            prompts = [p for p, _ in trace[b0:b0 + BATCH]]
            metas = [m for _, m in trace[b0:b0 + BATCH]]
            want = jpol.serve_batch(prompts, metas)
            got = ppol.serve_batch(prompts, metas)
            jpol.pool.drain()
            ppol.pool.drain()
            for i, (a, b) in enumerate(zip(want, got)):
                near += any(abs(a.similarity - t) <= 1e-5
                            for t in (TAU, SIGMA_MIN))
                assert (a.served_by, a.answer, a.static_origin) == \
                    (b.served_by, b.answer, b.static_origin), b0 + i
                assert a.similarity == b.similarity \
                    or abs(a.similarity - b.similarity) <= 1e-5, b0 + i
            for f in ("_valid_np", "_static_origin_np", "_written_at_np",
                      "_last_used_np", "_expires_np"):
                assert np.array_equal(getattr(jpol, f), getattr(ppol, f)), \
                    (b0, f)
            assert jpol.dyn_answers == ppol.dyn_answers, b0
        js, ps = jpol.stats(), ppol.stats()
        for k in ("static_hit_rate", "dynamic_hit_rate", "backend_rate",
                  "static_origin_rate", "judged", "approved", "rejected",
                  "judge_submitted", "judge_deduped"):
            assert js[k] == ps[k], k
        assert ps["approved"] > 0 and ps["dynamic_hit_rate"] > 0
        assert ppol.describe_index() == jpol.describe_index()
        assert ppol.describe_dyn_index() == jpol.describe_dyn_index()
        if path != "fused":
            st = ppol.dyn_index_stats()
            assert st.pop("scans") > 0
            assert st == jpol.dyn_index_stats()
            assert st["seals"] > 0 and st["merges"] > 0
        # the scalar entry over the same path agrees with the JAX one
        for p, m in trace[:16]:
            a, b = jpol.serve(p, m), ppol.serve(p, m)
            assert (a.served_by, a.answer, a.static_origin) == \
                (b.served_by, b.answer, b.static_origin), p
            assert abs(a.similarity - b.similarity) <= 1e-5 \
                or a.similarity == b.similarity, p
    finally:
        jpol.pool.stop()
        ppol.pool.stop()
    print(f"{path}: rows within 1e-5 of a threshold: {near} of {N}")
