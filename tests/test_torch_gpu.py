"""Card-only tests: each hand-written CUDA kernel of the port against its
plain PyTorch version, and the model on the card against the same
weights on the CPU. They skip without a CUDA card (a CUDA kernel has no
CPU mode); ``chip_smoke.py`` holds the same comparisons at the serving
path's full shapes. On the card: ``python -m pytest -m gpu
tests/test_torch_gpu.py``."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.index.ivf import build_ivf, quantize_rows
from repro_torch.kernels.decode_attention import kernel as dec_kernel
from repro_torch.kernels.embedding_bag import kernel as bag_kernel
from repro_torch.kernels.embedding_bag.ops import embedding_bag
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.fused_serve import kernel as fused_kernel
from repro_torch.kernels.fused_serve.ops import fused_serve_probe
from repro_torch.kernels.fused_serve.ref import fused_serve_ref
from repro_torch.kernels.ivf_scan import kernel as ivf_kernel
from repro_torch.kernels.ivf_scan.ops import ivf_scan
from repro_torch.kernels.ivf_scan.ref import NEG, ivf_scan_ref
from repro_torch.kernels.simsearch import kernel as ss_kernel
from repro_torch.kernels.simsearch.ref import simsearch_ref
from repro_torch.launch.workloads import build_workload
from repro_torch.models import attention as plain
from repro_torch.models import transformer as tr

torch.set_num_threads(1)
pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    """The card, decided per test (never at import, so every pytest
    worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _randn(gen, *shape, dtype=torch.float32):
    return torch.randn(shape, generator=gen, device=gen.device).to(dtype)


@pytest.mark.parametrize("B,N,d,k", [(5, 1000, 64, 8), (40, 3000, 64, 1),
                                     (3, 130, 8, 3), (16, 512, 128, 32)])
def test_simsearch_kernel_matches_plain(cuda, B, N, d, k):
    g = torch.Generator(device=cuda).manual_seed(B + N)
    q, c = _randn(g, B, d), _randn(g, N, d)
    before = ss_kernel.launches
    v, i = ss_kernel.simsearch(q, c, k)
    vr, ir = simsearch_ref(q, c, k)
    torch.cuda.synchronize()
    # one launch per chunk of MAX_QUERIES query rows (B=40 is two)
    assert ss_kernel.launches == before + -(-B // ss_kernel.MAX_QUERIES)
    assert torch.equal(i, ir)
    assert float((v - vr).abs().max()) <= 1e-5


def test_simsearch_kernel_ties_go_to_lowest_index(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    c = _randn(g, 5000, 64)
    c[4000] = c[9]
    c[2500] = c[9]
    _, i = ss_kernel.simsearch(c[9:10].clone(), c, 3)
    assert i[0].tolist() == [9, 2500, 4000]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,S,H,K,D", [(8, 40, 16, 8, 128), (1, 1000, 16, 8,
                                                             128),
                                       (2, 33, 8, 2, 64)])
def test_flash_kernel_matches_plain(cuda, dtype, tol, B, S, H, K, D):
    g = torch.Generator(device=cuda).manual_seed(S)
    q = _randn(g, B, S, H, D, dtype=dtype)
    k, v = (_randn(g, B, S, K, D, dtype=dtype) for _ in range(2))
    out = flash_kernel.flash_attention(q, k, v)
    ref = plain.causal_attention(q.float(), k.float(), v.float())
    assert out.dtype == dtype
    assert float((out.float() - ref).abs().max()) <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_decode_kernel_matches_plain(cuda, dtype, tol):
    g = torch.Generator(device=cuda).manual_seed(1)
    B, S, K, G, D = 8, 512, 8, 2, 128
    q = _randn(g, B, K * G, D, dtype=dtype)
    kc, vc = (_randn(g, B, S, K, D, dtype=dtype) for _ in range(2))
    lens = torch.tensor([1, 31, 32, 33, 200, 256, 511, 512],
                        dtype=torch.int32, device=cuda)
    out = dec_kernel.decode_attention(q, kc, vc, lens)
    ref = plain.decode_attention(q.float()[:, None], kc.float(), vc.float(),
                                 lens)[:, 0]
    assert out.dtype == dtype
    assert float((out.float() - ref).abs().max()) <= tol


def test_model_on_card_matches_cpu(cuda):
    """Same fp32 weights: the card (kernels) against the CPU (plain)."""
    cfg = dataclasses.replace(smoke_config("qwen3-1.7b"), dtype="float32",
                              head_dim=64)
    params = tr.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    params_gpu = {"layers": {k: v.to(cuda)
                             for k, v in params["layers"].items()},
                  **{k: v.to(cuda) for k, v in params.items()
                     if k != "layers"}}
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        3, 259, size=(2, 19))).long()
    lc, cc = tr.prefill(cfg, params, toks, max_len=32)
    lg, cg = tr.prefill(cfg, params_gpu, toks.to(cuda), max_len=32)
    assert torch.allclose(lg.cpu(), lc, atol=2e-4, rtol=2e-4)
    tok = torch.argmax(lc, -1)
    for _ in range(3):
        lc, cc = tr.decode_step(cfg, params, cc, tok)
        lg, cg = tr.decode_step(cfg, params_gpu, cg, tok.to(cuda))
        assert torch.allclose(lg.cpu(), lc, atol=2e-4, rtol=2e-4)
        tok = torch.argmax(lc, -1)


def _ivf_world(cuda, N, d, B, K, seed):
    """Clustered rows, queries near rows, and the port's IVF layout."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    centers = _randn(g, K, d)
    rows = centers[torch.randint(0, K, (N,), generator=g, device=cuda)] \
        + 0.3 * _randn(g, N, d)
    q = rows[torch.randint(0, N, (B,), generator=g, device=cuda)] \
        + 0.05 * _randn(g, B, d)
    return q, build_ivf(rows, n_clusters=K, iters=3)


IVF_CASES = [(2000, 32, 7, 32, 6, 24), (640, 48, 1, 12, 12, 48),
             (300, 16, 5, 4, 2, 4), (512, 16, 3, 8, 20, 64),
             (4096, 64, 40, 64, 8, 32)]


@pytest.mark.parametrize("N,d,B,K,nprobe,C", IVF_CASES)
def test_ivf_scan_kernel_matches_plain(cuda, N, d, B, K, nprobe, C):
    q, ivf = _ivf_world(cuda, N, d, B, K, seed=N + d)
    args = (q, ivf.centroids, ivf.codes, ivf.scales, ivf.row_ids)
    before = ivf_kernel.launches
    v, i = ivf_scan(*args, nprobe=nprobe, n_candidates=C)
    cap = ivf.codes.shape[1]
    vr, ir = ivf_scan_ref(*args, min(nprobe, K), min(C, min(nprobe, K) * cap))
    torch.cuda.synchronize()
    assert ivf_kernel.launches == before + 1     # B=40 is one launch too
    assert torch.equal(i, ir)
    assert float((v - vr).abs().max()) <= 1e-6
    assert bool(((i >= 0) | (v == NEG)).all())


def _tie_layout(cuda):
    """One vector under global ids 9 and 4 in two bands, pad slots."""
    rng = np.random.default_rng(3)
    d, cap = 16, 4
    rows = rng.standard_normal((4, d)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    rows = np.concatenate([rows[:1], rows])          # rows 0, 1 equal
    codes_all, scales_all = quantize_rows(rows)
    codes = np.zeros((2, cap, d), np.int8)
    scales = np.zeros((2, cap), np.float32)
    ids = np.full((2, cap), -1, np.int32)
    for (k, c), r, gid in zip([(0, 0), (1, 0), (0, 1), (1, 1), (1, 2)],
                              range(5), [9, 4, 11, 2, 7]):
        codes[k, c], scales[k, c], ids[k, c] = codes_all[r], \
            scales_all[r], gid
    t = [torch.from_numpy(x).to(cuda) for x in
         (np.stack([rows[0], rows[0]]), codes, scales, ids)]
    return torch.from_numpy(rows[:1].copy()).to(cuda), t


def test_ivf_scan_kernel_ties_pads_and_empty_batch(cuda):
    q, (cent, codes, scales, ids) = _tie_layout(cuda)
    v, i = ivf_scan(q, cent, codes, scales, ids, nprobe=2, n_candidates=8)
    vr, ir = ivf_scan_ref(q, cent, codes, scales, ids, 2, 8)
    assert torch.equal(i, ir) and i[0, :2].tolist() == [4, 9]
    assert i[0, 5:].tolist() == [-1, -1, -1] and bool((v[0, 5:] == NEG).all())
    assert float((v - vr).abs().max()) <= 1e-6
    before = ivf_kernel.launches
    v0, i0 = ivf_scan(q[:0], cent, codes, scales, ids, nprobe=2,
                      n_candidates=8)
    assert v0.shape == i0.shape == (0, 8) and ivf_kernel.launches == before


FUSED_CASES = [(2000, 32, 7, 32, 6, 24, 256, 16, 0.9),
               (640, 48, 1, 12, 12, 48, 100, 16, 0.5),
               (300, 16, 5, 4, 2, 4, 24, 4, 0.3),
               (300, 16, 3, 4, 2, 4, 32, 8, 0.0),      # all-invalid tier
               (4096, 64, 40, 64, 8, 32, 1200, 16, 0.7)]


@pytest.mark.parametrize("N,d,B,K,nprobe,C,cap_dyn,Cd,frac", FUSED_CASES)
def test_fused_serve_kernel_matches_plain(cuda, N, d, B, K, nprobe, C,
                                          cap_dyn, Cd, frac):
    q, ivf = _ivf_world(cuda, N, d, B, K, seed=N + cap_dyn)
    g = torch.Generator(device=cuda).manual_seed(cap_dyn)
    dyn = _randn(g, cap_dyn, d)
    dyn = dyn / dyn.norm(dim=1, keepdim=True)
    valid = torch.rand((cap_dyn,), generator=g, device=cuda) < frac
    if B > 1 and frac > 0:
        q[1] = dyn[int(torch.nonzero(valid)[0])]       # an exact tier hit
    args = (q, ivf.centroids, ivf.codes, ivf.scales, ivf.row_ids, dyn,
            valid)
    before = fused_kernel.launches
    got = fused_serve_probe(*args, nprobe=nprobe, n_candidates=C,
                            n_dyn_candidates=Cd, dyn_tile=512)
    cap = ivf.codes.shape[1]
    want = fused_serve_ref(*args, min(nprobe, K),
                           min(C, min(nprobe, K) * cap), Cd)
    torch.cuda.synchronize()
    assert fused_kernel.launches == before + 1
    for (v, i), (vr, ir) in ((got[:2], want[:2]), (got[2:], want[2:])):
        assert torch.equal(i, ir)
        assert float((v - vr).abs().max()) <= 1e-6
        assert bool(((i >= 0) | (v == NEG)).all())
    if frac == 0.0:
        assert bool((got[3] == -1).all())
    before = fused_kernel.launches
    empty = fused_serve_probe(q[:0], *args[1:], nprobe=nprobe,
                              n_candidates=C, n_dyn_candidates=Cd)
    assert empty[0].shape == (0, min(C, min(nprobe, K) * cap))
    assert fused_kernel.launches == before


# (V, d, B, m, dtype): the path's widths (d = 32 deep, d = 1 wide), the
# conformance family's odd case (d = 24, m = 7), d = 128, m = 1, a bf16
# table and a single-row table
BAG_CASES = [(4096, 32, 2048, 4, torch.float32),
             (4096, 1, 2048, 4, torch.float32),
             (37, 24, 5, 7, torch.float32),
             (512, 128, 16, 8, torch.float32),
             (100, 16, 300, 1, torch.float32),
             (512, 32, 64, 4, torch.bfloat16),
             (1, 8, 2, 2, torch.float32)]


@pytest.mark.parametrize("V,d,B,m,dtype", BAG_CASES)
def test_embedding_bag_kernel_matches_plain_exactly(cuda, V, d, B, m,
                                                    dtype):
    g = torch.Generator(device=cuda).manual_seed(V + d + m)
    table = _randn(g, V, d, dtype=dtype)
    ids = torch.randint(0, V, (B, m), generator=g, device=cuda,
                        dtype=torch.int32)
    ids[0, 0], ids[-1, -1] = 0, V - 1
    w = torch.rand((B, m), generator=g, device=cuda)
    w[1 % B] = 0.0                                   # an all-zero bag
    before = bag_kernel.launches
    out = bag_kernel.embedding_bag(table, ids, w)
    ref = embedding_bag_ref(table, ids, w)
    torch.cuda.synchronize()
    assert bag_kernel.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == (B, d)
    assert torch.equal(out, ref)          # same roundings, same order
    before = bag_kernel.launches
    empty = embedding_bag(table, ids[:0], w[:0])
    assert empty.shape == (0, d) and bag_kernel.launches == before


def test_wide_deep_serve_p99_full_width_on_card(cuda):
    """One full-width serve_p99 batch: 2 bag launches (deep and wide),
    scores identical to the same batch through the plain bag."""
    wl = build_workload("wide-deep", "serve_p99", device=cuda)
    before = bag_kernel.launches
    scores = wl.fn(*wl.args)
    torch.cuda.synchronize()
    assert bag_kernel.launches == before + 2
    saved = bag_kernel.embedding_bag
    bag_kernel.embedding_bag = embedding_bag_ref
    try:
        plain_scores = wl.fn(*wl.args)
    finally:
        bag_kernel.embedding_bag = saved
    assert scores.shape == (512, 1) and bool(scores.isfinite().all())
    assert torch.equal(scores, plain_scores)
