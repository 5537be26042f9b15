"""Port parity: the segmented dynamic-tier index. A port
``SegmentedIndex`` and a JAX ``SegmentedIndex``, both in the
full-recall configuration of ``tests/test_dyn_index.py`` (full probe,
candidate budgets covering every live row), see the same writes,
invalidations, seals and compactions; their exact-reranked ``topk`` must
give identical slots, scores within 1e-6, and the same telemetry, and
both must equal the flat masked scan. Segment layouts differ (the two
k-means seedings differ), the served results do not. Inputs are made
with numpy from a seed."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro.core import tiers as JT
from repro.index.segmented import SegmentedIndex as JaxSegmentedIndex
from repro_torch.core import tiers as PT
from repro_torch.index.segmented import SegmentedIndex

torch.set_num_threads(1)


def _full_recall(cls, capacity, d, tail_rows=16, compact_every=3, **kw):
    return cls(capacity, d, tail_rows=tail_rows, nprobe=None,
               n_candidates=4 * capacity, tail_candidates=tail_rows,
               compact_every=compact_every, **kw)


class _Pair:
    """A JAX tier + index and a port tier + index fed the same ops."""

    def __init__(self, capacity, d, **kw):
        self.jt = JT.make_dynamic_tier(capacity, d)
        self.pt = PT.make_dynamic_tier(capacity, d, device="cpu")
        self.jidx = _full_recall(JaxSegmentedIndex, capacity, d, **kw)
        self.pidx = _full_recall(SegmentedIndex, capacity, d,
                                 device="cpu", **kw)

    def write(self, slot, v, t):
        self.jt = JT._write(self.jt, slot, jnp.asarray(v), jnp.int32(0),
                            jnp.int32(-1), jnp.asarray(False), t)
        PT._write(self.pt, slot, torch.from_numpy(v), 0, -1, False, t)
        self.jidx.record_write(slot, v)
        self.pidx.record_write(slot, v)

    def invalidate(self, slot):
        self.jt = self.jt._replace(valid=self.jt.valid.at[slot].set(False))
        self.pt.valid[slot] = False
        self.jidx.invalidate(slot)
        self.pidx.invalidate(slot)

    def check(self, q):
        """Indexed lookups of both packages equal each other and the
        port's flat masked scan."""
        js, jj = JT.dynamic_lookup_batch(self.jt, jnp.asarray(q),
                                         index=self.jidx)
        ps, pj = PT.dynamic_lookup_batch(self.pt, torch.from_numpy(q),
                                         index=self.pidx)
        fs, fj = PT.dynamic_lookup_batch(self.pt, torch.from_numpy(q))
        assert np.array_equal(pj.numpy(), np.asarray(jj))
        assert np.array_equal(pj.numpy(), fj.numpy())
        for a, b in ((ps.numpy(), np.asarray(js)), (ps.numpy(), fs.numpy())):
            assert np.array_equal(np.isneginf(a), np.isneginf(b))
            fin = np.isfinite(a)
            np.testing.assert_allclose(a[fin], b[fin], rtol=0, atol=1e-6)
        jst = self.jidx.stats()
        pst = self.pidx.stats()
        assert pst.pop("scans") >= 0
        assert pst == jst


def _unit(rng, *shape):
    v = rng.standard_normal(shape).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def test_churn_matches_jax_and_flat():
    rng = np.random.default_rng(0)
    cap, d = 64, 16
    pair = _Pair(cap, d, tail_rows=8)
    for t in range(1, 120):
        slot = int(rng.integers(0, cap))
        if t % 17 == 0:
            pair.invalidate(slot)
        else:
            pair.write(slot, _unit(rng, d), t)
        if t % 20 == 0:
            pair.check(_unit(rng, 8, d))
    st_ = pair.pidx.stats()
    assert st_["seals"] > 5 and st_["merges"] > 0 and st_["tombstones"] > 0
    assert st_["scans"] > 0
    assert pair.pidx.describe() == pair.jidx.describe()


def test_tombstones_never_resurrect():
    """An overwritten or invalidated slot's old key is unfindable after
    the stale copy was sealed and survived a merge."""
    rng = np.random.default_rng(1)
    cap, d = 64, 8
    pair = _Pair(cap, d, tail_rows=8, compact_every=2)
    old = _unit(rng, d)
    pair.write(7, old, 1)
    gone = _unit(rng, d)
    pair.write(5, gone, 2)
    for t in range(3, 40):
        pair.write(int(rng.integers(8, cap)), _unit(rng, d), t)
    pair.write(7, _unit(rng, d), 99)
    pair.invalidate(5)
    q = np.stack([old, gone])
    pair.check(q)
    s, j = PT.dynamic_lookup_batch(pair.pt, torch.from_numpy(q),
                                   index=pair.pidx)
    assert (s < 0.999).all() and int(j[1]) != 5
    pair.jidx.compact()
    pair.pidx.compact()
    pair.check(q)


def test_empty_index_and_scalar_lookup_contract():
    cap, d = 16, 8
    pair = _Pair(cap, d, tail_rows=4)
    q = np.eye(d, dtype=np.float32)[0]
    s, j = PT.dynamic_lookup(pair.pt, torch.from_numpy(q), index=pair.pidx)
    assert float(s) == -np.inf and int(j) == 0
    pair.write(3, q.copy(), 1)
    s, j = PT.dynamic_lookup(pair.pt, torch.from_numpy(q), index=pair.pidx)
    js, jj = JT.dynamic_lookup(pair.jt, jnp.asarray(q), index=pair.jidx)
    assert int(j) == int(jj) == 3
    assert float(s) == pytest.approx(float(js), abs=1e-6)


def test_ttl_eviction_invalidates_index():
    rng = np.random.default_rng(3)
    cap, d = 32, 8
    pair = _Pair(cap, d, tail_rows=8)
    vecs = []
    for t in range(1, 21):
        v = _unit(rng, d)
        vecs.append(v)
        pair.write(t % cap, v, t)
    pair.jt = JT.evict_expired(pair.jt, now=30, ttl=15, index=pair.jidx)
    PT.evict_expired(pair.pt, now=30, ttl=15, index=pair.pidx)
    assert pair.pidx.stats()["live"] == int(pair.pt.valid.sum()) == 6
    pair.check(np.stack(vecs))


def test_background_compaction_and_bulk_load():
    rng = np.random.default_rng(4)
    cap, d = 96, 16
    pair = _Pair(cap, d, tail_rows=8, compact_every=2, background=True)
    slots = rng.choice(cap, 40, replace=False)
    vecs = _unit(rng, 40, d)
    for s, v in zip(slots, vecs):       # the tier rows behind bulk_load
        pair.jt = JT._write(pair.jt, int(s), jnp.asarray(v), jnp.int32(0),
                            jnp.int32(-1), jnp.asarray(False), 1)
        PT._write(pair.pt, int(s), torch.from_numpy(v), 0, -1, False, 1)
    pair.jidx.bulk_load(slots, vecs)
    pair.pidx.bulk_load(slots, vecs)
    pair.check(_unit(rng, 8, d))
    for t in range(2, 40):
        pair.write(int(rng.integers(0, cap)), _unit(rng, d), t)
        pair.jidx.wait_compaction()
        pair.pidx.wait_compaction()
    pair.pidx.wait_compaction()
    assert pair.pidx._compactor is not None
    assert not pair.pidx._compactor.is_alive()
    assert pair.pidx.stats()["merges"] > 0
    pair.check(_unit(rng, 8, d))


_OPS = st.lists(st.tuples(st.sampled_from(["write", "write", "invalidate"]),
                          st.integers(0, 23)), min_size=1, max_size=60)


@settings(max_examples=8, deadline=None)
@given(_OPS, st.integers(0, 2**31 - 1))
def test_prop_every_live_slot_findable_every_dead_slot_gone(ops, seed):
    """Random write/invalidate sequences: each live slot's own key finds
    that slot at score ~1, and no dead slot is ever returned."""
    rng = np.random.default_rng(seed)
    cap, d = 24, 8
    tier = PT.make_dynamic_tier(cap, d, device="cpu")
    idx = _full_recall(SegmentedIndex, cap, d, tail_rows=4,
                       compact_every=2, device="cpu")
    for t, (op, slot) in enumerate(ops, 1):
        if op == "write":
            v = _unit(rng, d)
            PT._write(tier, slot, torch.from_numpy(v), 0, -1, False, t)
            idx.record_write(slot, v)
        else:
            tier.valid[slot] = False
            idx.invalidate(slot)
    live = torch.nonzero(tier.valid)[:, 0]
    assert idx.stats()["live"] == len(live)
    if len(live):
        s, j = PT.dynamic_lookup_batch(tier, tier.emb[live], index=idx)
        assert torch.equal(j.long(), live)
        assert (s > 0.9999).all()
    s, j = PT.dynamic_lookup_batch(tier, torch.from_numpy(_unit(rng, 6, d)),
                                   index=idx)
    assert bool(tier.valid[j.long()].all()) or not len(live)
