"""Port parity: random insert / upsert / touch / touch_many /
evict_expired sequences drive a JAX dynamic tier and the port's tier
(updated in place) side by side; after every step all 8 fields must be
identical. Includes the ``ttl=0`` no-op and the legacy-ttl vs per-entry
expiry equivalence pinned by ``test_l1_freshness``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tiers as JT
from repro_torch.core import tiers as PT

torch.set_num_threads(1)
FIELDS = ("emb", "cls", "answer_ref", "static_origin", "valid",
          "last_used", "written_at", "expires_at")


def _assert_tiers_equal(jt, pt, where):
    for f in FIELDS:
        a = np.asarray(getattr(jt, f))
        b = getattr(pt, f).numpy()
        assert a.dtype == b.dtype, (where, f, a.dtype, b.dtype)
        assert np.array_equal(a, b), (where, f)


def _unit(rng, d):
    v = rng.standard_normal(d).astype(np.float32)
    return v / np.linalg.norm(v)


@pytest.mark.parametrize("seed", range(4))
def test_random_op_sequences_give_identical_tiers(seed):
    rng = np.random.default_rng(seed)
    cap, d = 8, 4
    jt = JT.make_dynamic_tier(cap, d)
    pt = PT.make_dynamic_tier(cap, d, device="cpu")
    keys = [_unit(rng, d) for _ in range(5)]   # few keys: dedup hits
    now = 0
    for step in range(40):
        now += int(rng.integers(0, 3))
        op = rng.choice(["insert", "upsert", "touch", "touch_many",
                         "evict", "evict_ttl", "evict_ttl0"])
        q = keys[int(rng.integers(0, len(keys)))]
        if rng.random() < 0.2:
            q = _unit(rng, d)
        cls, ref = int(rng.integers(0, 9)), int(rng.integers(-1, 9))
        exp = int(now + rng.integers(1, 6)) if rng.random() < 0.4 else 0
        if op == "insert":
            cap_arg = int(rng.integers(2, cap + 1)) \
                if rng.random() < 0.3 else None
            jt = JT.insert(jt, jnp.asarray(q), cls, ref, now, cap=cap_arg,
                           expires=exp)
            PT.insert(pt, torch.from_numpy(q), cls, ref, now, cap=cap_arg,
                      expires=exp)
        elif op == "upsert":
            enq = now - int(rng.integers(0, 4))     # stale promotions too
            jt = JT.upsert(jt, jnp.asarray(q), cls, ref, enq, last_used=now,
                           expires=exp)
            PT.upsert(pt, torch.from_numpy(q), cls, ref, enq, last_used=now,
                      expires=exp)
        elif op == "touch":
            s = int(rng.integers(0, cap))
            jt = JT.touch(jt, s, now)
            PT.touch(pt, s, now)
        elif op == "touch_many":
            slots = rng.choice(cap, size=3, replace=False)
            nows = now + rng.integers(0, 3, size=3)
            jt = JT.touch_many(jt, slots, nows)
            PT.touch_many(pt, slots, nows)
        elif op == "evict":
            jt = JT.evict_expired(jt, now)
            PT.evict_expired(pt, now)
        elif op == "evict_ttl":
            ttl = int(rng.integers(1, 8))
            jt = JT.evict_expired(jt, now, ttl=ttl)
            PT.evict_expired(pt, now, ttl=ttl)
        else:
            jt = JT.evict_expired(jt, 10**6, ttl=0)
            PT.evict_expired(pt, 10**6, ttl=0)
        _assert_tiers_equal(jt, pt, (step, op))
        assert np.array_equal(np.asarray(JT.live_mask(jt, now)),
                              PT.live_mask(pt, now).numpy())
        assert int(JT._lru_slot(jt, None, now)) == PT._lru_slot(pt, None,
                                                                 now)


@pytest.mark.parametrize("seed", [0, 1])
def test_evict_expired_per_entry_matches_legacy_ttl(seed):
    """Port twin of the test_l1_freshness pin: the per-entry path is
    identical to the legacy global-ttl wrapper on the stamps it induces,
    ttl=0 is a no-op, and both agree with the JAX tier."""
    rng = np.random.default_rng(seed)
    cap = 16
    valid = rng.integers(0, 2, cap).astype(bool)
    written = rng.integers(0, 200, cap).astype(np.int32)
    ttl, now = int(rng.integers(1, 64)), int(rng.integers(1, 200))

    def port_tier(expires=None):
        t = PT.make_dynamic_tier(cap, 4, device="cpu")
        t.valid[:] = torch.from_numpy(valid)
        t.written_at[:] = torch.from_numpy(written)
        if expires is not None:
            t.expires_at[:] = torch.from_numpy(expires)
        return t

    legacy = PT.evict_expired(port_tier(), now=now, ttl=ttl)
    per_entry = PT.evict_expired(port_tier(written + ttl), now=now)
    assert torch.equal(legacy.valid, per_entry.valid)
    untouched = PT.evict_expired(port_tier(), now=10**9, ttl=0)
    assert np.array_equal(untouched.valid.numpy(), valid)
    jt = JT.make_dynamic_tier(cap, 4)._replace(
        valid=jnp.asarray(valid), written_at=jnp.asarray(written))
    assert np.array_equal(
        np.asarray(JT.evict_expired(jt, now=now, ttl=ttl).valid),
        legacy.valid.numpy())


def test_lookups_match_jax():
    rng = np.random.default_rng(11)
    cap, d = 12, 8
    jt = JT.make_dynamic_tier(cap, d)
    pt = PT.make_dynamic_tier(cap, d, device="cpu")
    for t in range(9):
        q = _unit(rng, d)
        jt = JT.insert(jt, jnp.asarray(q), t, t, t, expires=t + 3)
        PT.insert(pt, torch.from_numpy(q), t, t, t, expires=t + 3)
    Q = np.stack([_unit(rng, d) for _ in range(5)])
    js, jj = JT.dynamic_lookup_batch(jt, jnp.asarray(Q))
    ps, pj = PT.dynamic_lookup_batch(pt, torch.from_numpy(Q))
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), atol=1e-6)
    assert np.array_equal(pj.numpy(), np.asarray(jj))
    for now in (None, 7):
        s1, j1 = JT.dynamic_lookup(jt, jnp.asarray(Q[0]), now=now)
        s2, j2 = PT.dynamic_lookup(pt, torch.from_numpy(Q[0]), now=now)
        assert int(j1) == int(j2) and abs(float(s1) - float(s2)) < 1e-6
    emb = rng.standard_normal((10, d)).astype(np.float32)
    st_j = JT.make_static_tier(jnp.asarray(emb), jnp.arange(10))
    st_p = PT.make_static_tier(emb, np.arange(10), device="cpu")
    np.testing.assert_allclose(st_p.emb.numpy(), np.asarray(st_j.emb),
                               atol=1e-6)
    s1, h1 = JT.static_lookup(st_j, jnp.asarray(Q[1]))
    s2, h2 = PT.static_lookup(st_p, torch.from_numpy(Q[1]))
    assert int(h1) == int(h2) and abs(float(s1) - float(s2)) < 1e-6


def test_cache_config_validation_matches_jax():
    for kw in ({"dup_threshold": 0.5}, {"rewrite_rate": -1.0}):
        with pytest.raises(ValueError):
            JT.CacheConfig(0.9, 0.9, **kw)
        with pytest.raises(ValueError):
            PT.CacheConfig(0.9, 0.9, **kw)
    assert PT.CacheConfig(0.9, 1.5, dup_threshold=0.5).tau_dynamic == 1.5
