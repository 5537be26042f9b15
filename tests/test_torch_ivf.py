"""Port parity: the IVF static index. The JAX package builds the packed
layout (its k-means seeds with ``jax.random``, which the port cannot
reproduce), ``ivf_from_numpy`` carries the same arrays over, and the
port's scan, rerank and search are held against the JAX oracle, its
Pallas kernel in interpret mode and its jnp path, on the IVF_SCAN cases
of ``test_kernel_conformance.py``. Inputs are made with numpy from a
seed.

Comparison: approximate scores within 1e-6 (the port sums the int8 dot
in fp64 and rounds once, the reference sums in fp32); candidate ids
identical, except at a position whose reference score lies within 1e-6
of its neighbour's (an approximate-score near-tie, which the exact
rerank decides). Such positions are counted; on these cases there are
none. The port's own ``build_ivf`` is held to properties."""
import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tiers as JT
from repro.index.ivf import IVFIndex as JaxIVFIndex
from repro.index.ivf import build_ivf as jax_build_ivf
from repro.index.ivf import quantize_rows as jax_quantize_rows
from repro.kernels.ivf_scan.ops import ivf_scan as jax_ivf_scan
from repro.kernels.ivf_scan.ops import ivf_search as jax_ivf_search
from repro.kernels.ivf_scan.ref import NEG as JAX_NEG
from repro.kernels.ivf_scan.ref import ivf_scan_ref as jax_ivf_scan_ref
from repro_torch.core import tiers as PT
from repro_torch.index.flat import cosine_topk as flat_topk
from repro_torch.index.ivf import (IVFIndex, build_ivf, ivf_from_numpy,
                                   quantize_rows)
from repro_torch.kernels.ivf_scan.ops import ivf_scan, ivf_search
from repro_torch.kernels.ivf_scan.ref import (NEG, ivf_scan_ref,
                                              order_candidates,
                                              threshold_survivors)
from repro_torch.kernels.simsearch.ref import topk_lowest_index
from test_torch_gpu import TIE_CASES, tie_layout

torch.set_num_threads(1)

# (N, d, B, K, nprobe, C): the IVF_SCAN cases and edge cases of
# test_kernel_conformance.py
CASES = [
    (512, 16, 3, 8, 3, 8),
    (2000, 32, 7, 32, 6, 24),
    (640, 48, 1, 12, 12, 48),     # full probe, single query
    (300, 8, 5, 4, 2, 4),         # tiny, C < nprobe * cap
    (64, 8, 0, 4, 2, 4),          # empty query batch
    (1, 8, 2, 1, 1, 1),           # single-row corpus, one cluster
    (2048, 32, 8, 16, 20, 64),    # nprobe > K: clamped to a full probe
    (4096, 32, 6, 64, 16, 64),    # nprobe 16 > 8, C = 64
    (600, 16, 4, 40, 12, 40),     # C = 40 > cap = 24
]
# the Pallas kernel in interpret mode takes about a second a case; its
# own conformance test holds it to the JAX oracle on every case
INTERPRET = (CASES[0], CASES[2], CASES[5])


@functools.lru_cache(maxsize=None)
def _make(case, seed=0):
    N, d, B, K, _, _ = case
    rng = np.random.default_rng(seed + 7 * N + d)
    centers = rng.standard_normal((max(2, K), d))
    rows = (centers[rng.integers(0, max(2, K), N)]
            + 0.3 * rng.standard_normal((N, d))).astype(np.float32)
    q = (rows[rng.integers(0, N, B)]
         + 0.05 * rng.standard_normal((B, d))).astype(np.float32)
    return rows, q, jax_build_ivf(rows, n_clusters=K, iters=3)


def _carry(jivf):
    return ivf_from_numpy(jivf.centroids, jivf.codes, jivf.scales,
                          jivf.row_ids, jivf.corpus, device="cpu")


def _assert_candidates(got, want, tol=1e-6) -> int:
    """Scores within ``tol``; ids identical except at reference near-ties
    (returned as a count)."""
    v, i = (np.asarray(x) for x in got)
    v_r, i_r = (np.asarray(x) for x in want)
    assert v.shape == v_r.shape and i.shape == i_r.shape
    assert i.dtype == np.int32 and v.dtype == np.float32
    np.testing.assert_allclose(v, v_r, rtol=0, atol=tol)
    assert ((i >= 0) | (v == NEG)).all()
    diff = i != i_r
    near = np.zeros_like(diff)
    gap = np.abs(np.diff(v_r, axis=1)) <= tol
    near[:, 1:] |= gap
    near[:, :-1] |= gap
    near[:, -1:] = True           # a tie with the first row left out
    assert not (diff & ~near).any(), np.argwhere(diff & ~near)[:5]
    return int(diff.sum())


def test_quantize_rows_matches_jax():
    rng = np.random.default_rng(0)
    rows = rng.standard_normal((257, 32)).astype(np.float32)
    rows[3] = 0.0                               # zero row: scale 0
    rows[7] *= 1e-30                            # denormal-range row
    rows[9, :] = np.linspace(-1, 1, 32)         # exact .5 roundings
    codes, scales = quantize_rows(rows)
    j_codes, j_scales = jax_quantize_rows(rows)
    assert codes.dtype == np.int8 and scales.dtype == np.float32
    assert np.array_equal(codes, np.asarray(j_codes))
    assert np.array_equal(scales, np.asarray(j_scales))


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_ivf_scan_matches_jax_ref_and_interpret(case):
    N, d, B, K, nprobe, C = case
    _, q, jivf = _make(case)
    ivf = _carry(jivf)
    Ke, cap = jivf.codes.shape[:2]
    np_eff = min(nprobe, Ke)
    c_eff = min(C, np_eff * cap)
    jargs = (jnp.asarray(q), jivf.centroids, jivf.codes, jivf.scales,
             jivf.row_ids)
    want_ref = jax_ivf_scan_ref(*jargs, np_eff, c_eff)
    qt = torch.from_numpy(q)
    pargs = (qt, ivf.centroids, ivf.codes, ivf.scales, ivf.row_ids)
    got = ivf_scan(*pargs, nprobe=nprobe, n_candidates=C)
    assert got[0].shape == (B, c_eff)
    near = _assert_candidates(got, want_ref)
    near += _assert_candidates(ivf_scan_ref(*pargs, np_eff, c_eff),
                               want_ref)
    if case in INTERPRET:
        want_pallas = jax_ivf_scan(*jargs, nprobe=nprobe, n_candidates=C,
                                   force="interpret")
        near += _assert_candidates(got, want_pallas)
    assert near == 0, f"{near} candidate positions differ at near-ties"


@pytest.mark.parametrize("case", CASES[:4] + CASES[6:],
                         ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("k", [1, 3])
def test_ivf_search_matches_jax(case, k):
    _, _, B, _, nprobe, C = case
    _, q, jivf = _make(case)
    ivf = _carry(jivf)
    k = min(k, C)
    want = jax_ivf_search(jnp.asarray(q), jivf.corpus, jivf.centroids,
                          jivf.codes, jivf.scales, jivf.row_ids, k=k,
                          nprobe=nprobe, n_candidates=C)
    got = ivf_search(torch.from_numpy(q), ivf.corpus, ivf.centroids,
                     ivf.codes, ivf.scales, ivf.row_ids, k=k,
                     nprobe=nprobe, n_candidates=C)
    assert got[1].dtype == torch.int32
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="candidate budget"):
        ivf_search(torch.from_numpy(q), ivf.corpus, ivf.centroids,
                   ivf.codes, ivf.scales, ivf.row_ids, k=C + 10 ** 6,
                   nprobe=nprobe, n_candidates=C)


def test_tie_across_bands_goes_to_lowest_global_id():
    """The same vector under global ids 9 and 4 in two different bands,
    plus pad slots: the lower global id comes first, pads sink as
    (NEG, -1), in the port and in the JAX oracle alike."""
    rng = np.random.default_rng(3)
    d, cap = 16, 4
    v = rng.standard_normal(d).astype(np.float32)
    v /= np.linalg.norm(v)
    others = rng.standard_normal((3, d)).astype(np.float32)
    others /= np.linalg.norm(others, axis=1, keepdims=True)
    rows = np.stack([v, others[0], v, others[1], others[2]])
    codes_all, scales_all = quantize_rows(rows)
    codes = np.zeros((2, cap, d), np.int8)
    scales = np.zeros((2, cap), np.float32)
    ids = np.full((2, cap), -1, np.int32)
    for (k, c), r, gid in zip([(0, 0), (0, 1), (1, 0), (1, 1), (1, 2)],
                              range(5), [9, 11, 4, 2, 7]):
        codes[k, c], scales[k, c], ids[k, c] = codes_all[r], \
            scales_all[r], gid
    cent = np.stack([v, v])
    q = v[None] + 0.0
    want = jax_ivf_scan_ref(jnp.asarray(q), jnp.asarray(cent),
                            jnp.asarray(codes), jnp.asarray(scales),
                            jnp.asarray(ids), 2, 8)
    got = ivf_scan(torch.from_numpy(q), torch.from_numpy(cent),
                   torch.from_numpy(codes), torch.from_numpy(scales),
                   torch.from_numpy(ids), nprobe=2, n_candidates=8)
    assert _assert_candidates(got, want) == 0
    assert NEG == JAX_NEG
    assert got[1][0, :2].tolist() == [4, 9]
    assert got[1][0, 5:].tolist() == [-1, -1, -1]
    assert (got[0][0, 5:] == NEG).all()


@pytest.mark.parametrize("K,cap,d,n_tied,C,all_equal", TIE_CASES)
def test_ties_straddling_the_cut_match_jax(K, cap, d, n_tied, C,
                                           all_equal):
    """Rows of exactly equal score across the C-th place (copied codes
    and scale, shuffled global ids, pads), C = 64 and C > cap, nprobe up
    to 12: the port's plain scan keeps the tied rows of lowest global id,
    in the JAX oracle's order."""
    arrays = tie_layout(K, cap, d, n_tied, C, seed=K + C,
                        all_equal=all_equal)
    want = jax_ivf_scan_ref(*(jnp.asarray(a) for a in arrays), K, C)
    got = ivf_scan(*(torch.from_numpy(a) for a in arrays), nprobe=K,
                   n_candidates=C)
    assert _assert_candidates(got, want) == 0
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    v = got[0].numpy()[0]
    assert (v[C // 2:] == v[C // 2]).all()          # the tie straddles C


def _scores(kind: str, m: int, rng) -> np.ndarray:
    v = rng.standard_normal(m).astype(np.float32) * 0.2
    if kind == "pads":                 # a quarter pads, as the layout
        v[rng.random(m) < 0.25] = NEG
    elif kind == "ties":               # a tied run across the cut
        v[rng.choice(m, m // 4, replace=False)] = np.float32(0.3)
    elif kind == "equal":
        v[:] = np.float32(0.5)
    elif kind == "all_pads":
        v[:] = NEG
    elif kind == "signed_zero":
        v[: m // 2] = np.float32(-0.0)
        v[m // 2:] = np.float32(0.0)
    elif kind == "narrow":             # scores a few ulps apart
        v = np.float32(0.75) + np.arange(m, dtype=np.float32) * \
            np.float32(2.0 ** -24)
        rng.shuffle(v)
    return v


@pytest.mark.parametrize("kind", ["random", "pads", "ties", "equal",
                                  "all_pads", "signed_zero", "narrow"])
@pytest.mark.parametrize("m,n", [(672, 32), (704, 64), (100, 99),
                                 (65, 1)])
def test_threshold_survivors_keep_the_best(kind, m, n):
    """The kernel's threshold step, mirrored on the CPU: selecting the
    best n among the survivors gives the best n of all keys (ids
    shuffled, so ties break by id), and for spread scores few keys past
    n survive."""
    rng = np.random.default_rng(m + n)
    v = torch.from_numpy(_scores(kind, m, rng))
    ids = torch.from_numpy(rng.permutation(m).astype(np.int32))
    keep = threshold_survivors(v, n)
    assert int(keep.sum()) >= n
    want = order_candidates(v[None], ids[None], n)
    got = order_candidates(v[keep][None], ids[keep][None], n)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    if kind in ("random", "pads"):
        assert int(keep.sum()) <= n + m // 8


def test_port_build_ivf_properties():
    """The port's own build: a partition of the corpus into bands of at
    most ``cap`` rows, int8 codes within half a step of each row, and a
    full probe with a corpus-wide budget equal to flat search."""
    N, d, K = 2048, 32, 16
    rng = np.random.default_rng(5)
    centers = rng.standard_normal((K, d))
    rows = (centers[rng.integers(0, K, N)]
            + 0.3 * rng.standard_normal((N, d))).astype(np.float32)
    ivf = build_ivf(torch.from_numpy(rows), n_clusters=K, iters=4)
    c = ivf.corpus.numpy()
    np.testing.assert_allclose(np.linalg.norm(c, axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(
        np.linalg.norm(ivf.centroids.numpy(), axis=1), 1.0, atol=1e-5)
    Kb, cap, db = ivf.codes.shape
    assert (Kb, db) == (K, d)
    assert cap == -(-math.ceil(N / K * 1.3) // 8) * 8
    ids = ivf.row_ids.numpy()
    assert np.array_equal(np.sort(ids[ids >= 0]), np.arange(N))
    assert ((ids >= 0).sum(axis=1) <= cap).all()
    k_, c_ = np.nonzero(ids >= 0)
    deq = ivf.codes.numpy()[k_, c_].astype(np.float32) \
        * ivf.scales.numpy()[k_, c_, None]
    err = np.abs(deq - c[ids[k_, c_]])
    assert (err <= ivf.scales.numpy()[k_, c_, None] / 2 + 1e-7).all()
    q = torch.from_numpy(rows[rng.integers(0, N, 8)]
                         + 0.1 * rng.standard_normal((8, d))
                         .astype(np.float32))
    s, i = ivf_search(q, ivf.corpus, ivf.centroids, ivf.codes, ivf.scales,
                      ivf.row_ids, k=3, nprobe=K, n_candidates=K * cap)
    s_f, i_f = flat_topk(q, ivf.corpus, k=3, corpus_normalized=True)
    assert torch.equal(i, i_f)
    np.testing.assert_allclose(s.numpy(), s_f.numpy(), rtol=0, atol=1e-5)
    # natural (unbalanced) assignment: cap = the largest cluster
    nat = build_ivf(rows, n_clusters=K, iters=4, max_imbalance=None,
                    device="cpu")
    nat_ids = nat.row_ids.numpy()
    assert np.array_equal(np.sort(nat_ids[nat_ids >= 0]), np.arange(N))
    assert nat.codes.shape[1] % 8 == 0


def test_topk_lowest_index_breaks_ties_by_index():
    """topk + stable-sort repair of tie rows equals numpy's stable
    descending sort, on rows full of ties and on rows without any."""
    rng = np.random.default_rng(2)
    tied = rng.integers(0, 6, (64, 40)).astype(np.float32)
    tied[0] = 1.0                                          # all tied
    tied[1, :3] = [-0.0, 0.0, -0.0]                        # signed zeros
    for sims in (tied, rng.standard_normal((16, 300)).astype(np.float32)):
        for k in (1, 3, 8):
            v, i = topk_lowest_index(torch.from_numpy(sims), k)
            want = np.argsort(-sims, axis=1, kind="stable")[:, :k]
            assert i.dtype == torch.int32
            assert np.array_equal(i.numpy(), want)
            assert np.array_equal(v.numpy(),
                                  np.take_along_axis(sims, want, 1))


def test_static_lookup_through_ivf_index_matches_jax():
    case = (2000, 32, 7, 32, 6, 24)
    _, q, jivf = _make(case, seed=2)
    ivf = _carry(jivf)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    jtier = JT.make_static_tier(jivf.corpus, jnp.arange(2000))
    ptier = PT.make_static_tier(np.array(jivf.corpus), np.arange(2000),
                                device="cpu")
    want = JT.static_lookup_batch(jtier, jnp.asarray(qn),
                                  index=JaxIVFIndex(jivf, nprobe=6,
                                                    n_candidates=24))
    idx = IVFIndex(ivf, nprobe=6, n_candidates=24)
    got = PT.static_lookup_batch(ptier, torch.from_numpy(qn), index=idx)
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=0, atol=1e-5)
    assert idx.describe() == JaxIVFIndex(jivf, nprobe=6,
                                         n_candidates=24).describe()
