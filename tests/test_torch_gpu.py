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
from repro_torch.index.flat import masked_cosine_topk
from repro_torch.index.ivf import build_ivf, quantize_rows
from repro_torch.kernels.decode_attention import kernel as dec_kernel
from repro_torch.kernels.decode_attention.ref import \
    decode_attention_split_ref
from repro_torch.kernels.embedding_bag import backward as bag_backward
from repro_torch.kernels.embedding_bag import kernel as bag_kernel
from repro_torch.kernels.embedding_bag.ops import embedding_bag
from repro_torch.kernels.embedding_bag.ref import (embedding_bag_backward,
                                                   embedding_bag_ref)
from repro_torch.kernels.flash_attention import backward as flash_backward
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


# ragged N (not a multiple of the 128-row tile), k 1 / 8 / 32, B 1 / 33 /
# 40 (two launches past 32), d 8 to 1024 (1024 runs a 2-stage ring)
@pytest.mark.parametrize("B,N,d,k", [(5, 1000, 64, 8), (40, 3000, 64, 1),
                                     (3, 130, 8, 3), (16, 512, 128, 32),
                                     (1, 4099, 64, 1), (33, 2049, 64, 8),
                                     (40, 777, 64, 32), (2, 1, 8, 1),
                                     (3, 300, 1024, 4)])
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


def test_simsearch_kernel_near_tie_inside_the_screening_margin(cuda):
    """Top-2 closer than the kernel's screening margin (2^-8): an exact
    copy of the query's row and a copy moved by 1 % of its norm."""
    g = torch.Generator(device=cuda).manual_seed(1)
    c = _randn(g, 5000, 64)
    c[4321] = c[9]
    c[3] = c[9] + 0.01 * c[9].norm() / 8 * _randn(g, 64)
    v, i = ss_kernel.simsearch(c[9:10].clone(), c, 3)
    vr, ir = simsearch_ref(c[9:10], c, 3)
    assert i[0].tolist() == ir[0].tolist() == [9, 4321, 3]
    assert 0 < float(v[0, 1] - v[0, 2]) < 2 ** -8
    assert float((v - vr).abs().max()) <= 1e-5


# bf16 with q tiles paired, unpaired and as the kernel picks
@pytest.mark.parametrize("dtype,tol,pair", [(torch.float32, 2e-5, None),
                                            (torch.bfloat16, 2e-2, None),
                                            (torch.bfloat16, 2e-2, False),
                                            (torch.bfloat16, 2e-2, True)])
@pytest.mark.parametrize("B,S,H,K,D", [
    (8, 40, 16, 8, 128), (1, 1000, 16, 8, 128), (2, 33, 8, 2, 64),
    # ragged tiles, S = 1, G = 1 and 4
    (2, 1, 16, 8, 128), (2, 15, 16, 8, 128), (2, 17, 16, 8, 128),
    (2, 65, 16, 8, 128), (2, 65, 8, 8, 128), (1, 100, 32, 8, 128),
    (2, 17, 4, 1, 64),
    # G = 16 (GLM-4-9B's group)
    (2, 65, 32, 2, 128), (1, 300, 16, 1, 64)])
def test_flash_kernel_matches_plain(cuda, dtype, tol, pair, B, S, H, K, D):
    g = torch.Generator(device=cuda).manual_seed(S)
    q = _randn(g, B, S, H, D, dtype=dtype)
    k, v = (_randn(g, B, S, K, D, dtype=dtype) for _ in range(2))
    out = flash_kernel.flash_attention(q, k, v, pair_tiles=pair)
    ref = plain.causal_attention(q.float(), k.float(), v.float())
    assert out.dtype == dtype
    assert float((out.float() - ref).abs().max()) <= tol


def _decode_lengths(spec, S):
    """The lengths of a case; "edge": 0, 1, C - 1, C, C + 1 for the
    kernel's chunk C, S and two more, clipped to S."""
    if spec == "edge":
        C = dec_kernel.CHUNK
        spec = [0, 1, C - 1, C, C + 1, S, 2 * C + 5, 3]
    return [min(x, S) for x in spec]


# (B, S, K, G, D, lengths): the serve shape, its edges, B = 1, S = 100
# and 300 (not a multiple of a chunk), G 1 / 4 / 8, D 64; G 16 (one
# full m16 head tile in bf16, two in fp32), 5 and 3 (padded head tiles)
# and 40 (three head tiles)
DECODE_CASES = [(8, 512, 8, 2, 128, [1, 31, 32, 33, 200, 256, 511, 512]),
                (8, 512, 8, 2, 128, "edge"),
                (8, 300, 8, 2, 128, "edge"),
                (1, 512, 8, 2, 128, [300]),
                (8, 100, 4, 1, 128, "edge"),
                (3, 100, 2, 4, 64, [100, 65, 0]),
                (8, 256, 1, 8, 64, "edge"),
                (8, 300, 2, 16, 128, "edge"),
                (8, 300, 2, 5, 128, "edge"),
                (8, 300, 2, 3, 64, "edge"),
                (2, 300, 1, 40, 128, [300, 129])]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,S,K,G,D,lens", DECODE_CASES)
def test_decode_kernel_matches_plain(cuda, dtype, tol, B, S, K, G, D, lens):
    g = torch.Generator(device=cuda).manual_seed(B + S + G)
    q = _randn(g, B, K * G, D, dtype=dtype)
    kc, vc = (_randn(g, B, S, K, D, dtype=dtype) for _ in range(2))
    lens = torch.tensor(_decode_lengths(lens, S), dtype=torch.int32,
                        device=cuda)
    before = dec_kernel.launches
    out = dec_kernel.decode_attention(q, kc, vc, lens)
    again = dec_kernel.decode_attention(q, kc, vc, lens)
    ref = plain.decode_attention(q.float()[:, None], kc.float(), vc.float(),
                                 lens)[:, 0]
    split = decode_attention_split_ref(q, kc, vc, lens, dec_kernel.CHUNK)
    torch.cuda.synchronize()
    assert dec_kernel.launches == before + 2     # one launch a call
    assert out.dtype == dtype
    assert torch.equal(out, again)               # splits merge in order
    assert float((out.float() - ref).abs().max()) <= tol
    assert float((out.float() - split).abs().max()) <= tol
    assert bool((out[lens == 0] == 0).all())


def test_launcher_serves_on_the_card_by_default(cuda):
    """``python -m repro_torch.launch.serve`` with no ``--device``: the
    card, its attention kernels, 0 router errors."""
    from repro_torch.launch import serve
    before = flash_kernel.launches, dec_kernel.launches, ss_kernel.launches
    stats = serve.main(["--requests", "24"])
    torch.cuda.synchronize()
    assert stats["errors"] == 0
    after = flash_kernel.launches, dec_kernel.launches, ss_kernel.launches
    assert all(a > b for a, b in zip(after, before))


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


@pytest.mark.parametrize("name", ["qwen2-moe-a2.7b", "llama4-scout-17b-a16e"])
def test_moe_model_on_card_matches_cpu(cuda, name):
    """The MoE smoke models (top-2 of 4 with a shared expert; top-1, GQA
    group 4) in fp32, head dim 64: the card (kernels, the dispatch on
    CUDA) against the CPU on the same weights."""
    cfg = dataclasses.replace(smoke_config(name), dtype="float32",
                              head_dim=64)
    params = tr.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    params_gpu = {"layers": {k: v.to(cuda)
                             for k, v in params["layers"].items()},
                  **{k: v.to(cuda) for k, v in params.items()
                     if k != "layers"}}
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        3, 259, size=(3, 21))).long()
    lc, cc = tr.prefill(cfg, params, toks, max_len=32)
    lg, cg = tr.prefill(cfg, params_gpu, toks.to(cuda), max_len=32)
    assert torch.allclose(lg.cpu(), lc, atol=2e-4, rtol=2e-4)
    tok = torch.argmax(lc, -1)
    for _ in range(3):
        lc, cc = tr.decode_step(cfg, params, cc, tok)
        lg, cg = tr.decode_step(cfg, params_gpu, cg, tok.to(cuda))
        assert torch.allclose(lg.cpu(), lc, atol=2e-4, rtol=2e-4)
        tok = torch.argmax(lc, -1)


@pytest.mark.parametrize("path", ["sort", "einsum"])
def test_moe_dispatch_on_card_matches_cpu_with_drops(cuda, path):
    """Qwen2-MoE's expert count and top-k (60, top-4) at d 256 in fp32:
    T 512 in 32 groups (sort) or T 32 (einsum), with experts 0 and 1
    favoured by every token, so both paths drop slots. Expert ids and
    kept slots identical on the card and the CPU; outputs within 1e-5
    of their max |y|."""
    from repro_torch.configs import QWEN2_MOE_A2_7B
    from repro_torch.models import moe
    cfg = QWEN2_MOE_A2_7B.moe
    d, F, E = 256, 128, cfg.n_experts
    rng = np.random.default_rng(7)
    w = {"router": rng.normal(size=(d, E)) * d ** -0.5,
         "wg": rng.normal(size=(E, d, F)) * d ** -0.5,
         "wu": rng.normal(size=(E, d, F)) * d ** -0.5,
         "wd": rng.normal(size=(E, F, d)) * F ** -0.5,
         "shared_wg": rng.normal(size=(d, 4 * F)) * d ** -0.5,
         "shared_wu": rng.normal(size=(d, 4 * F)) * d ** -0.5,
         "shared_wd": rng.normal(size=(4 * F, d)) * (4 * F) ** -0.5}
    w["router"][:, :2] += 4.0 / d
    T = 512 if path == "sort" else 32
    x = rng.normal(size=(T, d)) + 1.0
    w = {k: torch.from_numpy(v.astype(np.float32)) for k, v in w.items()}
    x = torch.from_numpy(x.astype(np.float32))
    fn = moe._moe_ffn_sort if path == "sort" else moe._moe_ffn_einsum
    yc, ac, ic, kc = fn(x, w, cfg)
    yg, ag, ig, kg = fn(x.to(cuda), {k: v.to(cuda) for k, v in w.items()},
                        cfg)
    assert torch.equal(ig.cpu(), ic) and torch.equal(kg.cpu(), kc)
    assert int((~kc).sum()) > 0
    err = float((yg.cpu() - yc).abs().max() / yc.abs().max())
    assert err <= 1e-5 and abs(float(ag) - float(ac)) <= 1e-5


def _ivf_world(cuda, N, d, B, K, seed):
    """Clustered rows, queries near rows, and the port's IVF layout."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    centers = _randn(g, K, d)
    rows = centers[torch.randint(0, K, (N,), generator=g, device=cuda)] \
        + 0.3 * _randn(g, N, d)
    q = rows[torch.randint(0, N, (B,), generator=g, device=cuda)] \
        + 0.05 * _randn(g, B, d)
    return q, build_ivf(rows, n_clusters=K, iters=3)


# nprobe 16 (each block of a cluster walks two bands) with C = 64;
# C = 40 > cap = 24; two 2664-row bands cut into three stage-sized units
# each; d = 528 (33 lanes' worth of 16-byte chunks a row); C = 4096 over
# two 7800-row bands (the leader's receive region overlays its stages)
# and over two 16256-row bands (the cluster shrinks to fit the lists)
IVF_CASES = [(2000, 32, 7, 32, 6, 24), (640, 48, 1, 12, 12, 48),
             (300, 16, 5, 4, 2, 4), (512, 16, 3, 8, 20, 64),
             (4096, 64, 40, 64, 8, 32), (4096, 64, 9, 64, 16, 64),
             (600, 16, 4, 40, 12, 40), (4096, 32, 5, 2, 2, 100),
             (400, 528, 3, 4, 3, 16), (12000, 64, 2, 2, 2, 4096),
             (25000, 16, 1, 2, 2, 4096)]


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


def tie_layout(K, cap, d, n_tied, C, seed, all_equal=False):
    """A numpy IVF layout whose query 0 has n_tied + 1 rows of exactly
    equal score straddling its C-th place: the codes and scale of its
    (C // 2)-th best row copied into n_tied other slots across the K
    bands (or into every slot: ``all_equal``). Global ids are shuffled,
    the last two slots of each band are pads. Returns (queries (2, d),
    centroids (K, d), codes (K, cap, d) int8, scales (K, cap), row ids
    (K, cap) int32), every array float32 or integer."""
    rng = np.random.default_rng(seed)
    rows = rng.standard_normal((K * cap, d)).astype(np.float32)
    codes, scales = quantize_rows(rows)
    codes, scales = codes.reshape(K, cap, d), scales.reshape(K, cap)
    ids = rng.permutation(K * cap).astype(np.int32).reshape(K, cap)
    ids[:, -2:] = -1
    q = rng.standard_normal((2, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    score = (codes.astype(np.float64) @ q[0].astype(np.float64)) * scales
    score[ids < 0] = -np.inf
    flat = np.argsort(-score, axis=None, kind="stable")
    src = np.unravel_index(flat[C // 2], score.shape)
    live = np.flatnonzero(ids.reshape(-1) >= 0)
    dst = live if all_equal else rng.choice(live, n_tied, replace=False)
    codes.reshape(-1, d)[dst] = codes[src]
    scales.reshape(-1)[dst] = scales[src]
    cent = rng.standard_normal((K, d)).astype(np.float32)
    cent /= np.linalg.norm(cent, axis=1, keepdims=True)
    return q, cent, codes, scales, ids


# (K, cap, d, n_tied, C, all_equal): nprobe = K = 12 bands, so blocks of
# a cluster walk two; C = 64 > cap = 40
TIE_CASES = [(12, 40, 32, 40, 32, False), (12, 40, 32, 80, 64, False),
             (12, 40, 32, 0, 64, True), (3, 48, 16, 30, 8, False)]


@pytest.mark.parametrize("K,cap,d,n_tied,C,all_equal", TIE_CASES)
def test_ivf_scan_kernel_ties_straddling_the_cut(cuda, K, cap, d, n_tied,
                                                  C, all_equal):
    arrays = tie_layout(K, cap, d, n_tied, C, seed=K + C,
                        all_equal=all_equal)
    args = [torch.from_numpy(a).to(cuda) for a in arrays]
    before = ivf_kernel.launches
    v, i = ivf_scan(*args, nprobe=K, n_candidates=C)
    vr, ir = ivf_scan_ref(*args, K, C)
    torch.cuda.synchronize()
    assert ivf_kernel.launches == before + 1
    assert torch.equal(i, ir)
    assert float((v - vr).abs().max()) <= 1e-6
    assert bool((v[0, C // 2:] == v[0, C // 2]).all())   # straddles C


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
               (4096, 64, 40, 64, 8, 32, 1200, 16, 0.7),
               # nprobe + tile units = 10 + 6 > 8, Cd = 64
               (4096, 64, 9, 64, 10, 48, 1200, 64, 0.6),
               # d = 272: 34 chunks of 16 bytes a bf16 row
               (300, 272, 3, 4, 2, 8, 40, 8, 0.6)]


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


# (V, d, groups, rows, dtype): a table and gathered rows larger than half
# the L2, taken in group order (fp32 d = 32 and bf16 d = 128), and a
# small table, taken in bag order whatever the groups; rows = bags a group
@pytest.mark.parametrize("V,d,groups,rows,dtype", [
    (300_000, 32, 40, 2048, torch.float32),
    (150_000, 128, 8, 8192, torch.bfloat16),
    (4096, 32, 40, 64, torch.float32)])
def test_embedding_bag_kernel_group_order_matches_plain_exactly(
        cuda, V, d, groups, rows, dtype):
    g = torch.Generator(device=cuda).manual_seed(V + d)
    table = _randn(g, V, d, dtype=dtype)
    B, m = rows * groups, 4
    ids = torch.randint(0, V, (B, m), generator=g, device=cuda,
                        dtype=torch.int32)
    w = torch.rand((B, m), generator=g, device=cuda)
    out = bag_kernel.embedding_bag(table, ids, w, groups)
    assert torch.equal(out, embedding_bag_ref(table, ids, w))
    assert torch.equal(out, bag_kernel.embedding_bag(table, ids, w))
    with pytest.raises(ValueError, match="divide"):
        bag_kernel.embedding_bag(table, ids[:-1], w[:-1], groups)


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


def test_embedding_bag_autograd_on_card_matches_plain(cuda):
    """The bag under autograd on the card (the kernel forward and the
    backward kernel, counted) against autograd through the plain
    version: the forward bit for bit, the table's gradient within rtol
    1e-5 and atol 1e-6 (the plain version's gather backward adds a row's
    terms by atomics, in another order each run; a row gathers ~3 terms
    here)."""
    g = torch.Generator(device=cuda).manual_seed(41)
    V, d, B, m, groups = 20_000, 32, 16_384, 4, 8
    table = _randn(g, V, d)
    ids = torch.randint(0, V, (B, m), generator=g, device=cuda,
                        dtype=torch.int32)
    w = torch.rand((B, m), generator=g, device=cuda)
    G = _randn(g, B, d)
    grads, outs, launched = [], [], []
    for bag in (lambda t: embedding_bag(t, ids, w, groups),
                lambda t: embedding_bag_ref(t, ids, w)):
        t = table.clone().requires_grad_(True)
        before = bag_kernel.launches, bag_backward.launches
        out = bag(t)
        torch.sum(out * G).backward()
        torch.cuda.synchronize()
        outs.append(out.detach())
        grads.append(t.grad)
        launched.append((bag_kernel.launches - before[0],
                         bag_backward.launches - before[1]))
    assert launched == [(1, 1), (0, 0)]
    assert torch.equal(outs[0], outs[1])
    assert grads[0].dtype == torch.float32
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="require grad"):
        embedding_bag(table, ids, w.clone().requires_grad_(True))


BWD_CASES = [(5, 7, 24, 37, 37), (1, 1, 16, 100, 100), (2, 2, 8, 1, 1),
             (64, 3, 33, 10, 3), (4096, 4, 32, 20_000, 500),
             (4096, 4, 1, 50_000, 50_000)]


@pytest.mark.parametrize("B,m,d,V,hi", BWD_CASES)
def test_embedding_bag_backward_kernel_is_deterministic(cuda, B, m, d, V,
                                                        hi):
    """Two launches of the backward kernel on the same inputs (ids
    repeated, rows no id names, zero weights) give the same bits, one
    launch each."""
    g = torch.Generator(device=cuda).manual_seed(B + d)
    ids = torch.randint(0, hi, (B, m), generator=g, device=cuda,
                        dtype=torch.int32)
    w = torch.rand((B, m), generator=g, device=cuda)
    w[0] = 0.0
    grad = _randn(g, B, d)
    before = bag_backward.launches
    a = bag_backward.embedding_bag_backward(grad, ids, w, V)
    b = bag_backward.embedding_bag_backward(grad, ids, w, V)
    torch.cuda.synchronize()
    assert bag_backward.launches == before + 2
    assert a.shape == (V, d) and a.dtype == torch.float32
    assert torch.equal(a, b)


@pytest.mark.parametrize("B,m,d,V,hi", BWD_CASES)
def test_embedding_bag_backward_kernel_matches_cpu_plain(cuda, B, m, d, V,
                                                         hi):
    """The backward kernel against the plain version on a CPU copy of
    the same inputs: bit for bit (both add a row's terms in ascending
    flat position, one rounding a multiply and an add)."""
    g = torch.Generator(device=cuda).manual_seed(7 * B + d)
    ids = torch.randint(0, hi, (B, m), generator=g, device=cuda,
                        dtype=torch.int32)
    w = torch.rand((B, m), generator=g, device=cuda)
    grad = _randn(g, B, d)
    got = bag_backward.embedding_bag_backward(grad, ids, w, V).cpu()
    want = embedding_bag_backward(grad.cpu(), ids.cpu(), w.cpu(), V)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="CUDA"):
        bag_backward.embedding_bag_backward(grad.cpu(), ids, w, V)


def test_cache_workload_run_ids_on_card(cuda, tmp_path):
    """``cache_workload.run`` at a small S on the card, one and two
    shards: the top-4 ids equal the plain version's on the same inputs,
    and the call is timed (CUDA events) beside its roofline."""
    from repro_torch.launch import cache_workload
    B, S, d, k = 100, 20_011, 64, 4
    corpus, q = cache_workload.lookup_inputs(B, S, d, cache_workload.SEED,
                                             cuda)
    want = simsearch_ref(q, corpus, k)[1]
    for shards in (1, 2):
        rec = cache_workload.run(B=B, S=S, d=d, k=k, shards=shards,
                                 out_dir=tmp_path)
        assert torch.equal(rec["ids"], want), shards
        assert rec["card_ms"] > 0 and rec["roofline"]["step_s"] > 0


@pytest.mark.parametrize("arch", ["sasrec", "mind", "bst", "wide-deep"])
def test_train_step_on_card_matches_cpu(cuda, arch):
    """One ``make_train_step`` step (the ``train_batch`` workload's fn)
    at smoke size, 64 rows, on the card and on the CPU from the same
    weights and batch: loss within rtol 1e-5, grad_norm within rtol
    1e-5, params within 1e-2 * lr absolute; Wide&Deep launches the bag
    twice (deep and wide) under autograd."""
    from repro_torch.configs import get_shape
    from repro_torch.launch.workloads import ADAMW, build_recsys
    from repro_torch.tree import flatten_with_path, tree_map
    cfg = smoke_config(arch)
    shape = dataclasses.replace(get_shape(cfg, "train_batch"),
                                global_batch=64)
    wl = build_recsys(cfg, shape, device="cpu", seed=2)

    def card(tree):
        return tree_map(lambda t: t.to(cuda), tree)
    p_cpu, _, m_cpu = wl.fn(*wl.args)
    before = bag_kernel.launches
    p_gpu, s_gpu, m_gpu = wl.fn(*(card(a) for a in wl.args))
    torch.cuda.synchronize()
    assert bag_kernel.launches - before == (2 if arch == "wide-deep"
                                            else 0)
    for k in ("loss", "grad_norm"):
        assert m_gpu[k].device.type == "cuda"
        torch.testing.assert_close(m_gpu[k].cpu(), m_cpu[k], rtol=1e-5,
                                   atol=0)
    for (name, a), (_, b) in zip(flatten_with_path(p_gpu),
                                 flatten_with_path(p_cpu)):
        assert a.device.type == "cuda", name
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-2 * ADAMW.lr,
                                   msg=name)
    assert int(s_gpu["step"]) == 1


# ---------------------------------------------------------------------------
# the trace simulator: the card against the CPU on a dyadic trace (every
# similarity exact in fp32 in any summation order, so every field must
# agree), through both cores and every feature gate
# ---------------------------------------------------------------------------

def _dyadic_sim_trace(n=1500):
    from repro_torch.data.synth_traces import LMARENA_LIKE, build_benchmark
    spec = dataclasses.replace(LMARENA_LIKE, n_requests=n + 500,
                               n_classes=400, n_topics=16,
                               volatile_frac=0.3)
    b = build_benchmark(spec)
    r = np.random.default_rng(5)

    def dy(x):
        return (np.round(x.astype(np.float64) * 256) / 256).astype(
            np.float32)
    return ((dy(b.static_emb), b.static_cls, dy(b.eval_emb[:n]),
             b.eval_cls[:n]),
            dict(volatile=b.eval_volatile[:n], key_id=b.eval_key[:n],
                 drift_every=128, rewritable=r.random(n) < 0.6,
                 judge_flip=r.random(n) < 0.05))


@pytest.mark.parametrize("core", ["blocked", "stepwise"])
def test_simulator_card_matches_cpu_on_dyadic_trace(cuda, core):
    from repro_torch.core import simulate as sim
    from repro_torch.core.tiers import CacheConfig
    args, kw = _dyadic_sim_trace()
    cfgs = [CacheConfig(0.90, 0.90, capacity=128, judge_latency=8),
            CacheConfig(0.90, 0.90, sigma_min=0.5, capacity=256,
                        judge_latency=8, l1=True, volatile_bypass=True,
                        ttl_volatile=40, ttl_stable=90),
            CacheConfig(0.86, 0.90, sigma_min=0.5, capacity=64,
                        judge_latency=32, judge_rate=0.5, rewrite=True,
                        rewrite_rate=0.02),
            CacheConfig(0.90, 0.90, capacity=128, judge_latency=12,
                        l1=True, ttl_stable=200)]
    if core == "blocked":
        cfgs = [dataclasses.replace(c, judge_latency=16) for c in cfgs]
    sweep = sim.sweep_from_configs(cfgs, [True, True, True, False])
    got = sim.simulate_sweep(*args, sweep, device=cuda, **kw)
    want = sim.simulate_sweep(*args, sweep, device="cpu", **kw)
    for name, g, w in zip(sim.SimResult._fields, got, want):
        assert g.device.type == "cuda", name
        assert torch.equal(g.cpu(), w), name
    assert int(want.promotions.sum()) > 0 and int(want.rewrites.sum()) > 0


def test_simulate_runs_on_the_card_by_default(cuda):
    from repro_torch.core import simulate as sim
    from repro_torch.core.tiers import CacheConfig
    args, _ = _dyadic_sim_trace(300)
    res = sim.simulate(*args, CacheConfig(0.9, 0.9, capacity=64,
                                          judge_latency=8), True)
    assert res.served_by.device.type == "cuda"
    assert torch.equal(res.served_by.cpu(), sim.simulate(
        *args, CacheConfig(0.9, 0.9, capacity=64, judge_latency=8), True,
        device="cpu").served_by)


def _within(tol):
    def check(got, want):
        assert float((got.float() - want).abs().max()) <= tol
    return check


def _guard_case(name, dev):
    """(kernel call, plain call, check) at a small shape on ``dev``."""
    g = torch.Generator(device=dev).manual_seed(len(name))
    if name == "simsearch":
        q, c = _randn(g, 5, 64), _randn(g, 1000, 64)

        def check(got, want):
            assert torch.equal(got[1], want[1])
            assert float((got[0] - want[0]).abs().max()) <= 1e-5
        return (lambda: ss_kernel.simsearch(q, c, 8),
                lambda: simsearch_ref(q, c, 8), check)
    if name == "flash_attention":
        q = _randn(g, 2, 33, 8, 64, dtype=torch.bfloat16)
        k, v = (_randn(g, 2, 33, 2, 64, dtype=torch.bfloat16)
                for _ in range(2))
        return (lambda: flash_kernel.flash_attention(q, k, v),
                lambda: plain.causal_attention(q.float(), k.float(),
                                               v.float()), _within(2e-2))
    if name == "decode_attention":
        q = _randn(g, 3, 8, 64, dtype=torch.bfloat16)
        kc, vc = (_randn(g, 3, 100, 2, 64, dtype=torch.bfloat16)
                  for _ in range(2))
        lens = torch.tensor([100, 65, 0], dtype=torch.int32, device=dev)
        return (lambda: dec_kernel.decode_attention(q, kc, vc, lens),
                lambda: plain.decode_attention(q.float()[:, None],
                                               kc.float(), vc.float(),
                                               lens)[:, 0], _within(2e-2))
    if name in ("ivf_scan", "fused_serve"):
        q, ivf = _ivf_world(dev, 2000, 32, 7, 32, seed=3)
        args = (q, ivf.centroids, ivf.codes, ivf.scales, ivf.row_ids)
        cap = ivf.codes.shape[1]

        def check(got, want):
            for (v, i), (vr, ir) in zip(zip(got[::2], got[1::2]),
                                        zip(want[::2], want[1::2])):
                assert torch.equal(i, ir)
                assert float((v - vr).abs().max()) <= 1e-6
        if name == "ivf_scan":
            return (lambda: ivf_scan(*args, nprobe=6, n_candidates=24),
                    lambda: ivf_scan_ref(*args, 6, min(24, 6 * cap)), check)
        dyn = _randn(g, 256, 32)
        dyn = dyn / dyn.norm(dim=1, keepdim=True)
        valid = torch.rand((256,), generator=g, device=dev) < 0.9
        return (lambda: fused_serve_probe(*args, dyn, valid, nprobe=6,
                                          n_candidates=24,
                                          n_dyn_candidates=16,
                                          dyn_tile=512),
                lambda: fused_serve_ref(*args, dyn, valid, 6,
                                        min(24, 6 * cap), 16), check)
    table = _randn(g, 512, 32)
    ids = torch.randint(0, 512, (16, 4), generator=g, device=dev,
                        dtype=torch.int32)
    w = torch.rand((16, 4), generator=g, device=dev)
    return (lambda: bag_kernel.embedding_bag(table, ids, w),
            lambda: embedding_bag_ref(table, ids, w), _within(0.0))


GUARDED = {"simsearch": ss_kernel, "flash_attention": flash_kernel,
           "decode_attention": dec_kernel, "ivf_scan": ivf_kernel,
           "fused_serve": fused_kernel, "embedding_bag": bag_kernel}


@pytest.mark.parametrize("name", sorted(GUARDED))
def test_kernel_launch_is_guarded_to_its_tensors_device(cuda, name):
    """Each kernel, launched on a side stream of its tensors' device,
    leaves the current device as it was and equals its plain version.
    The tensors sit on the host's last card while card 0 is current, so
    on a host with several cards the launch must make their card current
    (on one card the two are the same device)."""
    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    torch.cuda.set_device(0)
    kernel, plain_call, check = _guard_case(name, dev)
    side = torch.cuda.Stream(device=dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    before = GUARDED[name].launches
    with torch.cuda.stream(side):
        got = kernel()
    assert torch.cuda.current_device() == 0
    assert torch.cuda.current_stream(dev) == torch.cuda.default_stream(dev)
    side.synchronize()
    assert GUARDED[name].launches == before + 1
    check(got, plain_call())


def test_sharded_lookups_on_the_card_match_one_device(cuda):
    """The sharded static scan (a simsearch launch a shard), the IVF
    index a shard and the masked scan on the card's mesh against one
    device: the same ids; the shards of a card are views of one tier."""
    from repro_torch.index import sharded as PS
    from repro_torch.kernels.simsearch.ops import cosine_topk
    from repro_torch.launch.mesh import make_shard_mesh
    g = torch.Generator(device=cuda).manual_seed(11)
    corpus = _randn(g, 4001, 64)
    corpus = corpus / corpus.norm(dim=1, keepdim=True)
    q = corpus[:9] + 0.05 * _randn(g, 9, 64)
    mesh = make_shard_mesh(4)
    assert len(mesh.devices) == 4 and all(d.type == "cuda"
                                          for d in mesh.devices)
    before = ss_kernel.launches
    v, i = PS.sharded_cosine_topk(q, corpus, mesh, k=4)
    assert ss_kernel.launches == before + 4
    vr, ir = cosine_topk(q, corpus, k=4)
    assert torch.equal(i, ir) and float((v - vr).abs().max()) <= 1e-5
    # the policies' layout: per-shard blocks with no pad rows
    blocks = PS.shard_static_rows(corpus, mesh)
    if torch.cuda.device_count() == 1:
        assert blocks[1].data_ptr() == corpus[1001:].data_ptr()
    index = PS.ShardedIVFIndex(blocks, mesh, nprobe=64, n_candidates=256,
                               n_clusters=8)
    before = ivf_kernel.launches
    vi, ii = index.topk(q, 1)
    assert ivf_kernel.launches == before + 4
    assert torch.equal(ii[:, 0], ir[:, 0])
    valid = torch.rand((64,), generator=g, device=cuda) < 0.5
    vm, im = PS.sharded_masked_topk(q, corpus[:64], valid, mesh, k=2)
    vw, iw = masked_cosine_topk(q, corpus[:64], valid, k=2,
                                corpus_normalized=True)
    assert torch.equal(im, iw) and float((vm - vw).abs().max()) <= 1e-6


# ---------------------------------------------------------------------------
# training: the flash kernel under autograd, GraphSAGE and LM steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,S,H,K,D", [(2, 128, 16, 8, 128),
                                       (2, 65, 8, 2, 64)])
def test_flash_function_gradients_match_plain(cuda, dtype, tol, B, S, H, K,
                                              D):
    """``attention`` on CUDA tensors that need a gradient goes through
    ``FlashAttention`` (one kernel launch); its output against the plain
    version's in fp32, each row's error norm within tol of that row's
    norm; the q/k/v gradients of ``sum(out**2 * w)`` (the upstream
    gradient 2 out w carries the kernel's output into the backward)
    against the plain version differentiated by autograd in fp32,
    within tol x max |g|."""
    from repro_torch.kernels.flash_attention.ops import attention
    g = torch.Generator(device=cuda).manual_seed(S + H)
    q = _randn(g, B, S, H, D, dtype=dtype).requires_grad_(True)
    k, v = (_randn(g, B, S, K, D, dtype=dtype).requires_grad_(True)
            for _ in range(2))
    w = _randn(g, B, S, H, D)
    before = flash_kernel.launches
    out = attention(q, k, v)
    assert flash_kernel.launches == before + 1 and out.dtype == dtype
    qf, kf, vf = (t.detach().float().requires_grad_(True)
                  for t in (q, k, v))
    ref = plain.causal_attention(qf, kf, vf)
    diff = torch.linalg.vector_norm(out.detach().float() - ref, dim=-1)
    row_err = float((diff / torch.linalg.vector_norm(ref, dim=-1)).max())
    assert row_err <= tol, row_err
    got = torch.autograd.grad((out.float() ** 2 * w).sum(), (q, k, v))
    want = torch.autograd.grad((ref ** 2 * w).sum(), (qf, kf, vf))
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == dtype, name
        err = float((a.float() - b).abs().max())
        assert err <= tol * float(b.abs().max()), (name, err)


# the attention backward kernel: S 1 / 17 / 65 / 1000, and 129 / 191
# (ragged against the 64-wide q and kv tiles and the dQ kernel's 128-row
# blocks), G 1 / 2 / 4 (Minitron-8B's) / 5 / 6 / 16, D 64 and 128
BWD_SHAPES = [(2, 1, 16, 8, 128), (2, 17, 16, 8, 128), (2, 65, 16, 8, 128),
              (1, 1000, 16, 8, 128), (2, 65, 16, 16, 128),
              (2, 48, 40, 8, 128), (2, 65, 32, 2, 128), (2, 100, 4, 2, 64),
              (2, 129, 32, 8, 128), (2, 191, 48, 8, 128),
              (1, 191, 24, 4, 64)]


def _bwd_inputs(gen, B, S, H, K, D, dtype):
    q, do = (_randn(gen, B, S, H, D, dtype=dtype) for _ in range(2))
    k, v = (_randn(gen, B, S, K, D, dtype=dtype) for _ in range(2))
    o, lse = flash_kernel.flash_attention(q, k, v, return_lse=True)
    return q, k, v, o, lse, do


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,S,H,K,D", BWD_SHAPES)
def test_flash_backward_kernel_matches_plain(cuda, dtype, tol, B, S, H, K,
                                             D):
    """The backward kernel (one launch) on the forward kernel's output
    and log-sum-exp against the plain backward (fp32) on the same
    inputs: each of dq, dk, dv in the inputs' dtype and within tol x its
    largest |g|; at S 1 (one key: dS = 0, so dq and dk vanish and the
    plain version's hold only rounding) dq and dk within tol x max
    |dv|."""
    from repro_torch.kernels.flash_attention.ref import \
        flash_attention_bwd_ref
    args = _bwd_inputs(torch.Generator(device=cuda).manual_seed(S + H), B,
                       S, H, K, D, dtype)
    before = flash_backward.launches
    got = flash_backward.flash_attention_bwd(*args)
    assert flash_backward.launches == before + 1
    want = flash_attention_bwd_ref(*args)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == b.shape, name
        scale = float((want[2] if S == 1 and name != "dv" else b)
                      .abs().max())
        err = float((a.float() - b).abs().max())
        assert err <= tol * scale, (name, err, scale)


def test_flash_backward_kernel_is_deterministic(cuda):
    """Two launches on the same inputs (bf16, B 2, S 1000, G 2, the train
    shape B 2, S 4096, H 16, Kv 8, and fp32, G 5) give the same bits:
    every element is summed by one thread in a fixed order, with no
    atomics."""
    g = torch.Generator(device=cuda).manual_seed(3)
    for dtype, shape in ((torch.bfloat16, (2, 1000, 16, 8, 128)),
                         (torch.bfloat16, (2, 4096, 16, 8, 128)),
                         (torch.float32, (2, 130, 40, 8, 64))):
        args = _bwd_inputs(g, *shape, dtype)
        a = flash_backward.flash_attention_bwd(*args)
        b = flash_backward.flash_attention_bwd(*args)
        assert all(torch.equal(x, y) for x, y in zip(a, b)), dtype


@pytest.mark.parametrize("name", ["q", "k", "v", "o", "dout"])
def test_flash_backward_refuses_unaligned_bf16(cuda, name):
    """A bf16 CUDA view that starts 2 bytes past a 16-byte boundary
    (contiguous, so ``check_inputs`` takes it) raises ValueError before
    any launch: the kernels' TMA loads (and the delta pass's 16-byte
    loads) take 16-byte aligned bases only."""
    args = dict(zip(("q", "k", "v", "o", "lse", "dout"), _bwd_inputs(
        torch.Generator(device=cuda).manual_seed(5), 1, 64, 4, 2, 64,
        torch.bfloat16)))
    t = args[name]
    flat = torch.empty(t.numel() + 8, dtype=t.dtype, device=cuda)
    args[name] = flat[1:1 + t.numel()].view(t.shape)
    args[name].copy_(t)
    assert args[name].is_contiguous() and args[name].data_ptr() % 16 == 2
    before = flash_backward.launches
    with pytest.raises(ValueError, match="16-byte"):
        flash_backward.flash_attention_bwd(**args)
    assert flash_backward.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_forward_lse_matches_plain(cuda, dtype):
    """The forward kernel's ``return_lse`` against
    ``flash_attention_lse_ref`` within 1e-3 (natural-log units, fp32
    sums in another order), at a ragged S and G 5; the output equal to
    the call without it, bit for bit."""
    from repro_torch.kernels.flash_attention.ref import \
        flash_attention_lse_ref
    g = torch.Generator(device=cuda).manual_seed(4)
    q = _randn(g, 2, 77, 40, 128, dtype=dtype)
    k, v = (_randn(g, 2, 77, 8, 128, dtype=dtype) for _ in range(2))
    out, lse = flash_kernel.flash_attention(q, k, v, return_lse=True)
    assert lse.shape == (2, 40, 77) and lse.dtype == torch.float32
    assert torch.equal(out, flash_kernel.flash_attention(q, k, v))
    assert float((lse - flash_attention_lse_ref(q, k)).abs().max()) <= 1e-3


def test_flash_backward_wrapper_refuses_cpu_tensors(cuda):
    """The backward wrapper takes CUDA tensors of one device only: a CPU
    q, or CPU k/v/o/dout beside a CUDA q, raises and launches nothing."""
    g = torch.Generator(device=cuda).manual_seed(5)
    args = _bwd_inputs(g, 1, 9, 4, 2, 64, torch.bfloat16)
    before = flash_backward.launches
    cpu = [t.cpu() for t in args]
    with pytest.raises(ValueError, match="want q's CUDA device"):
        flash_backward.flash_attention_bwd(*cpu)
    with pytest.raises(ValueError, match="want q's CUDA device"):
        flash_backward.flash_attention_bwd(args[0], *cpu[1:])
    assert flash_backward.launches == before


def test_flash_function_backward_launches_the_kernel(cuda):
    """``attention`` under autograd on CUDA tensors: one forward launch
    with its log-sum-exp, and the backward one launch of the backward
    kernel, whose gradients equal the wrapper's on the saved output."""
    from repro_torch.kernels.flash_attention.ops import attention
    g = torch.Generator(device=cuda).manual_seed(6)
    q = _randn(g, 2, 65, 16, 128, dtype=torch.bfloat16).requires_grad_(True)
    k, v = (_randn(g, 2, 65, 8, 128, dtype=torch.bfloat16)
            .requires_grad_(True) for _ in range(2))
    do = _randn(g, 2, 65, 16, 128, dtype=torch.bfloat16)
    f0, b0 = flash_kernel.launches, flash_backward.launches
    out = attention(q, k, v)
    got = torch.autograd.grad(out, (q, k, v), do)
    assert (flash_kernel.launches - f0, flash_backward.launches - b0) \
        == (1, 1)
    o, lse = flash_kernel.flash_attention(q.detach(), k.detach(),
                                          v.detach(), return_lse=True)
    want = flash_backward.flash_attention_bwd(q.detach(), k.detach(),
                                              v.detach(), o, lse, do)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _on(tree, dev, float_dtype=None):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.to(dev, float_dtype)
                    if float_dtype is not None and t.is_floating_point()
                    else t.to(dev), tree)


def _leaf_close(got, want):
    from repro_torch.tree import flatten_with_path
    for (name, a), (_, b) in zip(flatten_with_path(got),
                                 flatten_with_path(want)):
        scale = float(b.abs().max())
        err = float((a.cpu().double() - b.double()).abs().max())
        assert err <= 1e-4 * scale + 1e-7, (name, err, scale)


@pytest.mark.parametrize("name", ["full_graph_sm", "molecule",
                                  "minibatch_lg"])
@pytest.mark.parametrize("width", ["smoke", "published"])
def test_gnn_step_on_card_matches_cpu(cuda, width, name):
    """A GraphSAGE train step at the smoke width (d_hidden 16, 5 classes)
    and at the published one (d_hidden 128, 41 classes), each shape at
    its own d_feat (``minibatch_lg`` cut to a 400-node graph and a batch
    of 32), on the card against the CPU from the same weights and batch,
    both in float64: loss and grad_norm within rtol 1e-5, every gradient
    leaf within 1e-4 x max |g| + 1e-7 (the card's segment sums add by
    atomics, in another order than the CPU's); no hand-written kernel is
    launched; then a float32 step runs on the card.

    Not float32 against float32: a pre-activation within fp32 rounding
    of 0 takes either side of the ReLU in two runs that round
    differently, and its gradient passes in one only. At the smoke width
    ``full_graph_sm`` seed 1, layer 0's node 958 unit 4 is -4.24e-7 in
    fp64 (the fp32 ulp at the largest pre-activation, 7.08, is 8.4e-7);
    a CPU build of torch 2.11 put it at +1.19e-7, and its ``w_self``
    gradient 3.2e-4 x max |g| from fp64, while the card and the same CPU
    with the edges permuted stayed on fp64's side, within 2.2e-7
    (``chip_smoke.py``'s ``[train gnn] ReLU band`` line). In float64
    the band is 2^29 times narrower."""
    from repro_torch.configs import get_arch, get_shape, smoke_config
    from repro_torch.launch.workloads import build_gnn
    from repro_torch.models import gnn
    from repro_torch.training import optimizer as O
    cfg = (smoke_config if width == "smoke" else get_arch)(
        "graphsage-reddit")
    shape = get_shape(get_arch("graphsage-reddit"), name)
    if name == "minibatch_lg":
        shape = dataclasses.replace(shape, n_nodes=400, n_edges=4000,
                                    batch_nodes=32)
    wl = build_gnn(cfg, shape, device="cpu", seed=1)
    params, _, batch = wl.args
    params, batch = _on(params, "cpu", torch.float64), \
        _on(batch, "cpu", torch.float64)
    loss = {"full_graph": gnn.full_graph_loss, "minibatch": gnn.minibatch_loss,
            "batched_graphs": gnn.batched_graphs_loss}[shape.kind]
    vg = O.value_and_grad(lambda p, b: loss(cfg, p, b))
    l_cpu, g_cpu = vg(params, batch)
    counts = {m: m.launches for m in (flash_kernel, dec_kernel, bag_kernel)}
    l_gpu, g_gpu = vg(_on(params, cuda), _on(batch, cuda))
    torch.cuda.synchronize()
    assert all(m.launches == n for m, n in counts.items())
    torch.testing.assert_close(l_gpu.cpu(), l_cpu, rtol=1e-5, atol=0)
    torch.testing.assert_close(O._global_norm(g_gpu).cpu(),
                               O._global_norm(g_cpu), rtol=1e-5, atol=0)
    _leaf_close(g_gpu, g_cpu)
    _, state, m = wl.fn(*(_on(a, cuda) for a in wl.args))
    assert int(state["step"]) == 1 and bool(m["loss"].isfinite())


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "qwen2-moe-a2.7b"])
def test_lm_train_step_on_card_matches_cpu(cuda, arch):
    """``train_loss`` and its gradients for an fp32 copy of the card's
    smoke config (head dim 64), B 2 x S 128, on the card (the flash
    kernel under ``FlashAttention``: two launches a layer under remat)
    against the CPU (plain attention) from the same weights and batch:
    loss and grad_norm within rtol 1e-5, gradient leaves within 1e-4 x
    max |g| + 1e-7; then one ``build_lm`` train step on the card."""
    from repro_torch.configs import get_shape, smoke_config_for
    from repro_torch.launch.workloads import build_lm
    from repro_torch.training import optimizer as O
    cfg = dataclasses.replace(smoke_config_for(arch, cuda), dtype="float32")
    shape = dataclasses.replace(get_shape(cfg, "train_4k"), seq_len=128)
    wl = build_lm(cfg, shape, device="cpu", seed=2, batch=2)
    params, _, batch = wl.args
    vg = O.value_and_grad(lambda p, b: tr.train_loss(cfg, p, b))
    l_cpu, g_cpu = vg(params, batch)
    before = flash_kernel.launches
    l_gpu, g_gpu = vg(_on(params, cuda), _on(batch, cuda))
    torch.cuda.synchronize()
    assert flash_kernel.launches - before == 2 * cfg.n_layers
    torch.testing.assert_close(l_gpu.cpu(), l_cpu, rtol=1e-5, atol=0)
    torch.testing.assert_close(O._global_norm(g_gpu).cpu(),
                               O._global_norm(g_cpu), rtol=1e-5, atol=0)
    _leaf_close(g_gpu, g_cpu)
    _, state, m = wl.fn(*(_on(a, cuda) for a in wl.args))
    assert int(state["step"]) == 1 and bool(m["loss"].isfinite())


def test_gumbel_noise_and_sampling_on_card(cuda):
    """The engine's noise is drawn on the card from its own generator:
    2^22 draws finite, mean within 6 standard errors of Euler's gamma
    and variance within 6 of pi^2/6 (SEs 6.3e-4 and 1.7e-3). With the
    same injected noise and logits the card's sampled ids equal the
    CPU's (a true fp32 division, then the add, on both), at temperature
    0 too. Two engines over one set of weights with one seed generate
    the same texts."""
    import math
    from repro_torch.configs import smoke_config_for
    from repro_torch.serving.engine import LLMEngine
    cfg = smoke_config_for("qwen3-1.7b", cuda)
    eng = LLMEngine(cfg, seed=3, max_len=64, temperature=0.7, device=cuda)
    cpu = LLMEngine(cfg, seed=3, max_len=64, temperature=0.7, device="cpu")
    n = 2 ** 22
    g = eng.gumbel((n,))
    assert g.device.type == "cuda" and g.dtype == torch.float32
    g = g.double()
    assert bool(g.isfinite().all())
    var = math.pi ** 2 / 6
    assert abs(float(g.mean()) - 0.5772156649) <= 6 * (var / n) ** 0.5
    assert abs(float(g.var()) - var) <= 6 * var * (4.4 / n) ** 0.5
    gen = torch.Generator().manual_seed(0)
    logits = torch.randn(8, 151_936, generator=gen) * 2
    noise = -torch.log(torch.empty(8, 151_936).exponential_(generator=gen))
    eng.gumbel = lambda shape: noise.to(cuda)
    cpu.gumbel = lambda shape: noise
    for T in (0.0, 0.3, 0.7, 1.5):
        eng.temperature = cpu.temperature = T
        got = eng._sample(logits.to(cuda))
        assert np.array_equal(got, cpu._sample(logits)), T
    del eng.gumbel, cpu.gumbel
    prompts = ["how do i fix my bike", "quick q: sell my router"]
    a, b = (LLMEngine(cfg, params=eng.params, seed=4, max_len=64,
                      temperature=0.7, device=cuda)
            .generate_batch(prompts, 8) for _ in range(2))
    assert a == b


def test_compression_and_buckets_on_card_match_cpu(cuda):
    """``quantize`` / ``roundtrip`` at sizes 0 to 1,000,003 in fp32 and
    bf16, ``compress_grads_with_feedback`` over three steps of a nested
    tree, and ``bucket_leaves`` / ``unbucket``: the card's bits equal the
    CPU's."""
    from repro_torch.distributed import compression as C
    from repro_torch.distributed.overlap import bucket_leaves
    from repro_torch.tree import leaves
    gen = torch.Generator().manual_seed(0)
    for n in (0, 1, 255, 256, 257, 4096, 1_000_003):
        x = torch.randn(n, generator=gen) * 30
        for xx in (x, x.bfloat16()):
            q, s, m = C.quantize(xx.to(cuda))
            qc, sc, mc = C.quantize(xx)
            assert m == mc == n and torch.equal(q.cpu(), qc)
            assert torch.equal(s.cpu().view(torch.int32),
                               sc.view(torch.int32))
            assert torch.equal(C.roundtrip(xx.to(cuda)).cpu()
                               .view(torch.int32),
                               C.roundtrip(xx).view(torch.int32))

    def tree(step):
        g = torch.Generator().manual_seed(step)
        return {"w": torch.randn(300, 70, generator=g) * 0.01,
                "b": [torch.randn(7, generator=g).bfloat16(),
                      torch.randn(2, 3, 5, generator=g) * 100]}
    res_d = C.init_residual(_on(tree(0), cuda))
    res_c = C.init_residual(tree(0))
    for step in range(3):
        qd, res_d = C.compress_grads_with_feedback(_on(tree(step), cuda),
                                                   res_d)
        qc, res_c = C.compress_grads_with_feedback(tree(step), res_c)
        for a, b in zip(leaves(qd) + leaves(res_d),
                        leaves(qc) + leaves(res_c)):
            if isinstance(a, int):
                assert a == b
            else:
                assert torch.equal(a.cpu().view(torch.uint8),
                                   b.view(torch.uint8)), step
    for bb in (4 * 2 ** 20, 4096):
        vd, unb = bucket_leaves(_on(tree(5), cuda), bb)
        vc, _ = bucket_leaves(tree(5), bb)
        assert [v.device.type for v in vd] == ["cuda"] * len(vc)
        assert all(torch.equal(a.cpu(), b) for a, b in zip(vd, vc))
        back = unb(vd)
        assert all(a.dtype == b.dtype and torch.equal(a.cpu(), b)
                   for a, b in zip(leaves(back), leaves(tree(5))))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-3)])
def test_decode_kernel_lse_matches_plain(cuda, dtype, tol):
    """``return_lse``: the output equals the call without it, and each
    head's log-sum-exp equals the plain version's within ``tol``
    (natural-log units; sums in another order), -inf exactly where the
    length is 0; lengths across the split boundaries, G 2 and 5."""
    from repro_torch.models.attention import decode_attention_lse
    g = torch.Generator(device=cuda).manual_seed(4)
    B, S, K, D = 6, 700, 4, 128
    lens = torch.tensor([0, 1, 127, 128, 300, 700], dtype=torch.int32,
                        device=cuda)
    for G in (2, 5):
        q = _randn(g, B, K * G, D, dtype=dtype)
        kc, vc = (_randn(g, B, S, K, D, dtype=dtype) for _ in range(2))
        out, lse = dec_kernel.decode_attention(q, kc, vc, lens,
                                               return_lse=True)
        assert torch.equal(out, dec_kernel.decode_attention(q, kc, vc, lens))
        _, ref = decode_attention_lse(q.float(), kc.float(), vc.float(),
                                      lens)
        live = torch.isfinite(ref)
        assert torch.equal(live, torch.isfinite(lse))
        assert not bool(live[0].any()) and bool(live[1:].all())
        assert float((lse[live] - ref[live]).abs().max()) <= tol


@pytest.fixture
def nccl_mesh(cuda, tmp_path):
    """An NCCL group of one rank (a FileStore under ``tmp_path``) and its
    smoke mesh (1, 1), torn down after the test."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_smoke_mesh
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield make_smoke_mesh(1)
    finally:
        dist.destroy_process_group()


def test_cuda_dtensors_reach_the_kernels(nccl_mesh):
    """On a one-rank NCCL mesh, CUDA DTensors go through the kernels on
    their local shards, never the plain versions: a smoke LM train step
    through ``build_lm(mesh=)`` launches flash 2 a layer; a decode step
    over the sequence-sharded cache launches decode a layer (with its
    log-sum-exp); a Wide&Deep step with a row-sharded table launches the
    bag forward and backward 2 each; each loss equals the unsharded
    step's on the card to 1e-4."""
    from repro_torch.configs import get_shape, smoke_config_for
    from repro_torch.kernels.embedding_bag import backward as bag_bwd
    from repro_torch.launch.workloads import build_lm, build_recsys
    mesh, cuda = nccl_mesh, torch.device("cuda")
    cfg = dataclasses.replace(smoke_config_for("qwen3-1.7b", cuda),
                              dtype="float32")
    shape = dataclasses.replace(get_shape(cfg, "train_4k"), seq_len=128)
    plain_wl = build_lm(cfg, shape, device="cuda", seed=1, batch=2)
    ref = float(plain_wl.fn(*plain_wl.args)[2]["loss"])
    wl = build_lm(cfg, shape, device="cuda", seed=1, batch=2, mesh=mesh)
    before = flash_kernel.launches
    m = wl.fn(*wl.args)[2]
    torch.cuda.synchronize()
    assert flash_kernel.launches - before == 2 * cfg.n_layers
    assert float(m["loss"].full_tensor()) == pytest.approx(ref, rel=1e-4)

    dshape = dataclasses.replace(get_shape(cfg, "decode_32k"), seq_len=256)
    ref_logits = build_lm(cfg, dshape, device="cuda", seed=1, batch=4)
    ref_logits = ref_logits.fn(*ref_logits.args)[0]
    dwl = build_lm(cfg, dshape, device="cuda", seed=1, batch=4, mesh=mesh)
    before = dec_kernel.launches
    logits = dwl.fn(*dwl.args)[0].full_tensor()
    torch.cuda.synchronize()
    assert dec_kernel.launches - before == cfg.n_layers
    assert float((logits - ref_logits).abs().max()) <= \
        1e-4 * float(ref_logits.abs().max())

    rcfg = dataclasses.replace(smoke_config("wide-deep"), sparse_vocab=256)
    rshape = dataclasses.replace(get_shape(rcfg, "train_batch"),
                                 global_batch=64)
    rplain = build_recsys(rcfg, rshape, device="cuda")
    rref = float(rplain.fn(*rplain.args)[2]["loss"])
    rwl = build_recsys(rcfg, rshape, device="cuda", mesh=mesh)
    f0, b0 = bag_kernel.launches, bag_bwd.launches
    rm = rwl.fn(*rwl.args)[2]
    torch.cuda.synchronize()
    assert (bag_kernel.launches - f0, bag_bwd.launches - b0) == (2, 2)
    assert float(rm["loss"].full_tensor()) == pytest.approx(rref, rel=1e-4)
