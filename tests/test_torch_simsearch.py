"""Port parity: the PyTorch simsearch path (plain version, ``cosine_topk``
dispatch, ``FlatIndex``, the tiers' batched static lookup) against the
JAX package's Pallas kernel in interpret mode and its jnp oracle, on the
SIMSEARCH family's cases of ``test_kernel_conformance.py``. Inputs are
made with numpy from a seed. Indices exact, scores within 1e-5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.simsearch.ops import cosine_topk as jax_cosine_topk
from repro.kernels.simsearch.ref import simsearch_ref as jax_simsearch_ref
from repro_torch.core import tiers as PT
from repro_torch.index.flat import FlatIndex, cosine_topk as flat_topk
from repro_torch.kernels.simsearch import kernel as ss_kernel
from repro_torch.kernels.simsearch.ops import cosine_topk
from repro_torch.kernels.simsearch.ref import simsearch_ref

torch.set_num_threads(1)

# (B, N, d, k, tile_n): the SIMSEARCH cases of test_kernel_conformance
CASES = [
    (4, 256, 32, 1, 128),
    (8, 1000, 64, 4, 256),      # N not a multiple of the tile
    (16, 512, 128, 8, 64),
    (1, 64, 16, 2, 64),         # single query row
    (3, 130, 8, 3, 128),        # 2-row remainder
]


def _inputs(case, seed=0):
    B, N, d, _, _ = case
    rng = np.random.default_rng(seed + 1000 * N + d)
    return (rng.standard_normal((B, d)).astype(np.float32),
            rng.standard_normal((N, d)).astype(np.float32))


def _assert_same(got, want):
    v, i = (np.asarray(x) for x in got)
    v_r, i_r = (np.asarray(x) for x in want)
    assert v.shape == v_r.shape and i.shape == i_r.shape
    assert np.array_equal(i.astype(np.int64), i_r.astype(np.int64))
    np.testing.assert_allclose(v, v_r, rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_port_simsearch_matches_jax_interpret_and_ref(case):
    q, c = _inputs(case)
    k, tile = case[3], case[4]
    want_pallas = jax_cosine_topk(jnp.asarray(q), jnp.asarray(c), k=k,
                                  tile_n=tile, force="interpret")
    want_ref = jax_simsearch_ref(jnp.asarray(q), jnp.asarray(c), k)
    qt, ct = torch.from_numpy(q), torch.from_numpy(c)
    for got in (simsearch_ref(qt, ct, k), cosine_topk(qt, ct, k=k)):
        assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
        _assert_same(got, want_pallas)
        _assert_same(got, want_ref)


def test_port_simsearch_tie_breaking_lowest_index():
    """The lowest-index tie case of test_kernel_conformance: duplicate
    corpus rows come back lowest index first."""
    q = np.zeros((1, 8), np.float32)
    q[0, 0] = 1.0
    near = np.zeros(8, np.float32)
    near[:2] = (1.0, 0.3)
    exact = np.zeros(8, np.float32)
    exact[0] = 1.0
    orth = np.zeros(8, np.float32)
    orth[1] = 1.0
    c = np.stack([near, exact, exact, orth])
    _, i_jax = jax_cosine_topk(jnp.asarray(q), jnp.asarray(c), k=3,
                               tile_n=2, force="interpret")
    _, i = cosine_topk(torch.from_numpy(q), torch.from_numpy(c), k=3)
    assert i[0].tolist() == [1, 2, 0] == [int(x) for x in i_jax[0]]


@pytest.mark.parametrize("k", [1, 3])
def test_port_flat_index_and_static_lookup_match_jax(k):
    """FlatIndex (through the fused dispatch) and the flat-module oracle
    agree with JAX's simsearch oracle; the tiers' batched static lookup
    is its top-1 column."""
    q, c = _inputs((6, 300, 64, k, 128), seed=5)
    want = jax_simsearch_ref(jnp.asarray(q), jnp.asarray(c), k)
    qt, ct = torch.from_numpy(q), torch.from_numpy(c)
    qn = qt / qt.norm(dim=-1, keepdim=True)
    _assert_same(FlatIndex(ct).topk(qn, k), want)
    _assert_same(flat_topk(qt, ct, k), want)
    tier = PT.make_static_tier(c, np.arange(300), device="cpu")
    s, h = PT.static_lookup_batch(tier, qn)
    np.testing.assert_allclose(s.numpy(), np.asarray(want[0])[:, 0],
                               atol=1e-5, rtol=0)
    assert np.array_equal(h.numpy(), np.asarray(want[1])[:, 0])


def test_port_simsearch_empty_batch_and_k_equals_n():
    c = torch.from_numpy(_inputs((2, 5, 8, 5, 64))[1])
    v, i = cosine_topk(torch.zeros((0, 8)), c, k=1)
    assert v.shape == (0, 1) and i.shape == (0, 1)
    q = torch.from_numpy(_inputs((2, 5, 8, 5, 64))[0])
    want = jax_simsearch_ref(jnp.asarray(q.numpy()), jnp.asarray(c.numpy()),
                             5)
    _assert_same(cosine_topk(q, c, k=5), want)


def test_kernel_wrapper_takes_cuda_tensors_only():
    """On a CPU tensor the wrapper never runs the plain version in the
    kernel's place: the kernel entry raises and its count stays put,
    while the dispatch picks the plain version by device."""
    q, c = (torch.from_numpy(x) for x in _inputs(CASES[0]))
    before = ss_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        ss_kernel.simsearch(q, c, 1)
    v, i = cosine_topk(q, c, k=1)
    vr, ir = simsearch_ref(q, c, 1)
    assert torch.equal(i, ir) and torch.equal(v, vr)
    assert ss_kernel.launches == before
