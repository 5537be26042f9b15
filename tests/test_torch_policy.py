"""Port parity: one cross-framework differential of the batched Krites
serving path. The same 500-request trace (DEMO_INTENTS x DEMO_PREFIXES)
goes through the JAX ``KritesPolicy.serve_batch`` and the port's, in
batches of 8, with a stub backend, an ``OracleJudge``, the same embedder
weights and static tier, and ``pool.drain()`` after each batch. Every
row must have the same served_by, answer, static_origin and promotions,
and similarity within 1e-5; rows whose reference score lies within 1e-5
of a threshold are counted and reported."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.judge import OracleJudge as JaxOracle
from repro.core.policy import KritesPolicy as JaxKrites
from repro.core.tiers import CacheConfig as JaxConfig
from repro.core.tiers import make_static_tier as jax_static_tier
from repro.embedding.embedder import Embedder as JaxEmbedder
from repro_torch.core.judge import OracleJudge
from repro_torch.core.policy import BaselinePolicy, KritesPolicy
from repro_torch.core.tiers import CacheConfig, make_static_tier
from repro_torch.embedding.embedder import Embedder
from repro_torch.launch.serve import (DEMO_INTENTS, build_demo_tier,
                                      demo_requests)

torch.set_num_threads(1)
N, BATCH, STATIC_ROWS = 500, 8, 200
TAU, SIGMA_MIN, CAPACITY = 0.92, 0.3, 32


def _backend_batch(ps):
    return [f"gen({p})" for p in ps]


def _near(x, taus):
    return any(abs(x - t) <= 1e-5 for t in taus)


def test_krites_serve_batch_matches_jax_on_500_requests():
    jemb = JaxEmbedder(d_out=64)
    pemb = Embedder(d_out=64, w1=np.asarray(jemb.w1), w2=np.asarray(jemb.w2),
                    device="cpu")
    rows = np.asarray(jemb.batch(DEMO_INTENTS), np.float32)
    answers = [f"[curated] {p}" for p in DEMO_INTENTS]
    ptier, answers, texts = build_demo_tier(rows, answers,
                                            static_rows=STATIC_ROWS,
                                            texts=DEMO_INTENTS, device="cpu")
    pad = np.random.default_rng(7).normal(
        size=(STATIC_ROWS - len(DEMO_INTENTS), 64)).astype(np.float32)
    jtier = jax_static_tier(jnp.asarray(np.concatenate([rows, pad])),
                            jnp.arange(STATIC_ROWS))
    np.testing.assert_allclose(ptier.emb.numpy(), np.asarray(jtier.emb),
                               atol=1e-6)
    kw = dict(backend_fn=lambda p: f"gen({p})", d=64, n_workers=1,
              backend_batch_fn=_backend_batch, static_texts=texts)
    jpol = JaxKrites(JaxConfig(TAU, TAU, sigma_min=SIGMA_MIN,
                               capacity=CAPACITY),
                     jtier, answers, jemb, judge_fn=JaxOracle(), **kw)
    ppol = KritesPolicy(CacheConfig(TAU, TAU, sigma_min=SIGMA_MIN,
                                    capacity=CAPACITY),
                        ptier, answers, pemb, judge_fn=OracleJudge(),
                        device="cpu", **kw)
    trace = demo_requests(N)
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
                row = b0 + i
                near += _near(a.similarity, (TAU, SIGMA_MIN))
                assert (a.served_by, a.answer, a.static_origin) == \
                    (b.served_by, b.answer, b.static_origin), row
                assert a.similarity == b.similarity \
                    or abs(a.similarity - b.similarity) <= 1e-5, row
            # promotions landed identically: mirrors and answers agree
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
        assert ps["static_origin_rate"] > ps["static_hit_rate"]
    finally:
        jpol.pool.stop()
        ppol.pool.stop()
    print(f"rows within 1e-5 of a threshold: {near} of {N}")


def test_serve_batch_equals_scalar_serve():
    """The port's own batch-equals-scalar contract (the JAX package's
    test_serve_batch twin), with LRU pressure and a global ttl."""
    emb = Embedder(d_out=64, seed=3, device="cpu")
    tier, answers, texts = build_demo_tier(
        emb.batch(DEMO_INTENTS), [f"[curated] {p}" for p in DEMO_INTENTS],
        static_rows=64, texts=DEMO_INTENTS, device="cpu")

    def mk():
        return BaselinePolicy(CacheConfig(TAU, TAU, capacity=16, ttl=40),
                              tier, answers, emb,
                              backend_fn=lambda p: f"gen({p})", d=64,
                              backend_batch_fn=_backend_batch, device="cpu")
    scalar_pol, batch_pol = mk(), mk()
    trace = demo_requests(160, seed=1)
    scalar = [scalar_pol.serve(p, m) for p, m in trace]
    batched = []
    for b0 in range(0, len(trace), 32):
        chunk = trace[b0:b0 + 32]
        batched += batch_pol.serve_batch([p for p, _ in chunk],
                                         [m for _, m in chunk])
    for i, (a, b) in enumerate(zip(scalar, batched)):
        assert (a.served_by, a.answer, a.static_origin) == \
            (b.served_by, b.answer, b.static_origin), i
        assert a.similarity == b.similarity \
            or abs(a.similarity - b.similarity) < 1e-5, i
    assert scalar_pol.events == batch_pol.events
    assert scalar_pol.stats() == batch_pol.stats()
    assert np.array_equal(scalar_pol.dyn.valid.numpy(),
                          batch_pol.dyn.valid.numpy())
    assert np.array_equal(scalar_pol._last_used_np, batch_pol._last_used_np)


@pytest.mark.parametrize("opt", ["index", "dyn_index", "mesh", "fused", "l1",
                                 "freshness", "adaptive", "wal", "rewriter"])
def test_unported_options_raise(opt):
    tier = make_static_tier(np.eye(4, dtype=np.float32), np.arange(4),
                            device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        KritesPolicy(CacheConfig(0.9, 0.9, capacity=4), tier, list("abcd"),
                     embed_fn=None, backend_fn=None, judge_fn=OracleJudge(),
                     d=4, device="cpu", **{opt: object()})
