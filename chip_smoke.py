#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py              # every phase; needs one CUDA card
    python3 chip_smoke.py --quick      # build + one check per kernel

Phases, each fatal on failure:

1. device: fail at once without CUDA; print the card's name and power
   limit as ``nvidia-smi`` gives them;
2. build: compile the five CUDA kernels from ``src/repro_torch/csrc``
   (one nvcc per source, in parallel), then build the 4,194,304-row
   demo static tier and its IVF layout (K = 8192, cap = 672);
3. kernels: hold simsearch, flash attention, decode attention, the IVF
   band scan and the fused two-tier probe against their plain PyTorch
   versions on the card at the serving path's shapes (planted ties,
   pads, empty and 40-row batches, an all-invalid dynamic tier), and
   time each beside its plain version, a library call or composite that
   computes the same function (used nowhere in the port) and the bound
   computed from the shapes;
4. serve: full-width Qwen3-1.7B with random weights behind the
   4,194,304-row static tier, 128 requests from 32 concurrent clients
   through CacheRouter -> KritesPolicy.serve_batch -> BatchingFrontend
   -> LLMEngine, three times on one engine: the flat path (simsearch),
   the IVF + segmented path (ivf_scan) and the fused path
   (fused_serve). Each kernel's launches are counted over each run;
   the flat run's decisions are checked against the plain static top-1,
   the other two runs' against a twin policy served in lockstep with
   the plain versions on the same layout; the model's outputs are
   checked against the same model with plain attention.

The line before the last is one JSON object with a record per kernel;
the last line is ``{"ok": true, "device": {...}}``. Imports nothing of
JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}

STATIC_ROWS = 4_194_304     # launch/cache_workload.py:38-40 tier shape
EMB_DIM = 64
SCORE_TOL = 1e-5            # served scores vs the plain fp32 scores
ATTN_TOL = 2e-2             # bf16 kernel output vs fp32 plain output
LOGIT_REL_TOL = 5e-2        # bf16 model, kernels vs plain attention
SERVE_REQUESTS = 128
IVF_NPROBE, IVF_C = 8, 32   # IVFIndex / FusedServe defaults
DYN_CAPACITY, DYN_CD = 512, 16
SEG_ROWS, COMPACT_EVERY = 16, 2   # small, so the run seals and merges
N_BATCH_SETS = 16           # query batches cycled while timing: their
                            # probed bands (~12 MB each) exceed the L2


class PhaseFailed(RuntimeError):
    pass


def need(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseFailed(msg)


def bound(bytes_moved: float, ops: float, dtype: str):
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    operations over the card's peak for ``dtype``."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn(i)``, by CUDA events around
    ``iters`` back-to-back calls after ``warmup`` calls."""
    import torch
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for i in range(iters):
        fn(i)
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def kernel_counters():
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.fused_serve import kernel as uk
    from repro_torch.kernels.ivf_scan import kernel as ik
    from repro_torch.kernels.simsearch import kernel as sk
    return {"simsearch": sk, "flash_attention": fk,
            "decode_attention": dk, "ivf_scan": ik, "fused_serve": uk}


def reset_counts() -> None:
    for mod in kernel_counters().values():
        mod.launches = 0


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _cos64(q, corpus, idx):
    """fp64 cosine of each query row against the corpus rows ``idx``."""
    c = corpus[idx.long()].double()                       # (B, k, d)
    qd = q.double()[:, None, :]
    return (qd * c).sum(-1) / (qd.norm(dim=-1) * c.norm(dim=-1)
                               ).clamp_min(1e-300)


def compare_topk(name, q, corpus, got, want, stats):
    """Indices identical to the plain version's; scores within SCORE_TOL
    of the plain version's and of the fp64 cosine of the same rows."""
    import torch
    v, i = got
    vr, ir = want
    need(v.shape == vr.shape and i.dtype == ir.dtype,
         f"{name}: shapes/dtypes {tuple(v.shape)}/{i.dtype} vs "
         f"{tuple(vr.shape)}/{ir.dtype}")
    need(bool(v.isfinite().all()), f"{name}: non-finite scores")
    need(torch.equal(i, ir), f"{name}: {int((i != ir).sum())} indices "
         f"differ from the plain version's")
    err = max(float((v - vr).abs().max()),
              float((v - _cos64(q, corpus, i).float()).abs().max()))
    stats["max_abs_err"] = max(stats["max_abs_err"], err)
    need(err <= SCORE_TOL, f"{name}: score error {err:.3g} > {SCORE_TOL}")


def check_simsearch(quick: bool) -> dict:
    import torch
    from repro_torch.kernels.simsearch import kernel as K
    from repro_torch.kernels.simsearch.ref import simsearch_ref

    g = torch.Generator(device="cuda").manual_seed(0)
    corpus = torch.randn((STATIC_ROWS, EMB_DIM), generator=g, device="cuda")
    stats = {"max_abs_err": 0.0}

    def queries(B):
        # half near-duplicates of tier rows (hits), half random (misses)
        rows = torch.randint(0, STATIC_ROWS, (B,), generator=g,
                             device="cuda")
        q = torch.randn((B, EMB_DIM), generator=g, device="cuda")
        near = corpus[rows] + 0.05 * q
        return torch.where((torch.arange(B, device="cuda") % 2 == 0)[:, None],
                           near, q).contiguous()

    for B in ((32,) if quick else (1, 8, 32)):
        q = queries(B)
        compare_topk(f"simsearch B={B}", q, corpus, K.simsearch(q, corpus, 1),
                     simsearch_ref(q, corpus, 1), stats)
    small = torch.randn((1000, EMB_DIM), generator=g, device="cuda")
    qs = torch.randn((5, EMB_DIM), generator=g, device="cuda")
    compare_topk("simsearch B=5 N=1000 k=8", qs, small,
                 K.simsearch(qs, small, 8), simsearch_ref(qs, small, 8),
                 stats)
    # planted ties in three different blocks' stripes: lowest index first
    tied = corpus.clone()
    tied[2_000_001] = corpus[7]
    tied[3_000_000] = corpus[7]
    qt = corpus[7:8].clone()
    _, it = K.simsearch(qt, tied, 3)
    _, itr = simsearch_ref(qt, tied, 3)
    need(it[0].tolist() == [7, 2_000_001, 3_000_000] == itr[0].tolist(),
         f"simsearch planted tie: kernel {it[0].tolist()}, plain "
         f"{itr[0].tolist()}")
    del tied
    print(f"[kernels] simsearch: indices identical, max_abs_err "
          f"{stats['max_abs_err']:.3g}, planted tie order ok")
    rec = {"name": "simsearch", "route": "cuda",
           "source": "src/repro_torch/csrc/simsearch.cu",
           "replaces": "src/repro/kernels/simsearch/kernel.py:93",
           "max_abs_err": stats["max_abs_err"]}
    if quick:
        return rec
    B = 32
    q = queries(B)
    qn = q / q.norm(dim=-1, keepdim=True)
    cn = corpus / corpus.norm(dim=-1, keepdim=True)
    rec["ms"] = cuda_ms(lambda i: K.simsearch(q, corpus, 1), 20)
    rec["plain_ms"] = cuda_ms(lambda i: simsearch_ref(q, corpus, 1), 5)
    rec["library_ms"] = cuda_ms(lambda i: torch.topk(qn @ cn.T, 1), 10)
    rec["bound_ms"], rec["bound_by"] = bound(
        (STATIC_ROWS * EMB_DIM + B * EMB_DIM) * 4 + B * 8,
        2 * B * STATIC_ROWS * EMB_DIM, "float32")
    for b in (1, 8):
        ms = cuda_ms(lambda i: K.simsearch(q[:b].contiguous(), corpus, 1), 20)
        print(f"[kernels] simsearch B={b} N={STATIC_ROWS}: {ms:.4f} ms")
    return rec


def check_flash(quick: bool) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.models.attention import causal_attention

    g = torch.Generator(device="cuda").manual_seed(1)
    H, Kv, D = 16, 8, 128

    def inputs(B, S):
        def r(*shape):
            return torch.randn(shape, generator=g, device="cuda",
                               dtype=torch.bfloat16)
        return r(B, S, H, D), r(B, S, Kv, D), r(B, S, Kv, D)

    err = 0.0
    for B, S in ((8, 40), (8, 64), (1, 1000)):
        q, k, v = inputs(B, S)
        out = K.flash_attention(q, k, v)
        need(out.dtype == torch.bfloat16 and out.shape == q.shape,
             f"flash B={B} S={S}: output {out.dtype} {tuple(out.shape)}")
        ref = causal_attention(q.float(), k.float(), v.float())
        e = float((out.float() - ref).abs().max())
        need(math.isfinite(e) and e <= ATTN_TOL,
             f"flash B={B} S={S}: max abs err {e:.3g} > {ATTN_TOL}")
        err = max(err, e)
    print(f"[kernels] flash_attention: max_abs_err {err:.3g}")
    rec = {"name": "flash_attention", "route": "cuda",
           "source": "src/repro_torch/csrc/flash_attention.cu",
           "replaces": "src/repro/kernels/flash_attention/kernel.py:84",
           "max_abs_err": err}
    if quick:
        return rec
    B, S = 8, 64
    q, k, v = inputs(B, S)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    rec["ms"] = cuda_ms(lambda i: K.flash_attention(q, k, v), 200)
    rec["plain_ms"] = cuda_ms(lambda i: causal_attention(q, k, v), 50)
    rec["library_ms"] = cuda_ms(lambda i: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), 200)
    pairs = S * (S + 1) // 2                  # causal (query, key) pairs
    rec["bound_ms"], rec["bound_by"] = bound(
        2 * (2 * B * S * H * D + 2 * B * S * Kv * D),
        4 * B * H * D * pairs, "bfloat16")
    q, k, v = inputs(1, 1000)
    ms = cuda_ms(lambda i: K.flash_attention(q, k, v), 20)
    print(f"[kernels] flash_attention B=1 S=1000: {ms:.4f} ms")
    return rec


def check_decode(quick: bool) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import kernel as K
    from repro_torch.models.attention import decode_attention

    g = torch.Generator(device="cuda").manual_seed(2)
    B, S, Kv, G, D, L = 8, 512, 8, 2, 128, 28
    H = Kv * G
    lengths = torch.tensor([1, 37, 64, 100, 255, 256, 400, 512],
                           dtype=torch.int32, device="cuda")

    def r(*shape):
        return torch.randn(shape, generator=g, device="cuda",
                           dtype=torch.bfloat16)
    q = r(B, H, D)
    # one cache per layer, as the engine holds them: timing cycles over
    # them, so each call reads its cache from HBM, not from L2
    kc, vc = r(L, B, S, Kv, D), r(L, B, S, Kv, D)
    out = K.decode_attention(q, kc[0], vc[0], lengths)
    need(out.dtype == torch.bfloat16 and out.shape == q.shape,
         f"decode: output {out.dtype} {tuple(out.shape)}")
    ref = decode_attention(q.float()[:, None], kc[0].float(), vc[0].float(),
                           lengths)[:, 0]
    err = float((out.float() - ref).abs().max())
    need(math.isfinite(err) and err <= ATTN_TOL,
         f"decode: max abs err {err:.3g} > {ATTN_TOL}")
    print(f"[kernels] decode_attention: max_abs_err {err:.3g}")
    rec = {"name": "decode_attention", "route": "cuda",
           "source": "src/repro_torch/csrc/decode_attention.cu",
           "replaces": "src/repro/kernels/decode_attention/kernel.py:95",
           "max_abs_err": err}
    if quick:
        return rec
    mask = (torch.arange(S, device="cuda")[None, :]
            < lengths[:, None])[:, None, None, :]            # (B,1,1,S)
    qt = q[:, :, None, :]                                    # (B,H,1,D)
    kt, vt = kc.transpose(2, 3), vc.transpose(2, 3)          # (L,B,K,S,D)
    rec["ms"] = cuda_ms(lambda i: K.decode_attention(
        q, kc[i % L], vc[i % L], lengths), 280)
    rec["plain_ms"] = cuda_ms(lambda i: decode_attention(
        q[:, None], kc[i % L], vc[i % L], lengths), 56)
    rec["library_ms"] = cuda_ms(lambda i: F.scaled_dot_product_attention(
        qt, kt[i % L], vt[i % L], attn_mask=mask, enable_gqa=True), 280)
    live = int(lengths.sum())
    rec["bound_ms"], rec["bound_by"] = bound(
        2 * (2 * B * H * D + 2 * live * Kv * D) + 4 * B,
        4 * live * H * D, "bfloat16")
    return rec


def build_static_ivf():
    """The serve runs' 4,194,304-row demo tier, built as ``build_service``
    builds it, and its IVF layout. Returns (tier, IVF, build seconds)."""
    import torch
    from repro_torch.embedding.embedder import Embedder
    from repro_torch.index.ivf import build_ivf
    from repro_torch.launch.serve import DEMO_INTENTS, build_demo_tier

    embed = Embedder(d_out=EMB_DIM, device="cuda")
    tier, _, _, _ = build_demo_tier(
        embed.batch(DEMO_INTENTS), [f"[curated] {p}" for p in DEMO_INTENTS],
        static_rows=STATIC_ROWS, texts=DEMO_INTENTS, device="cuda")
    torch.cuda.synchronize()
    t0 = time.monotonic()
    ivf = build_ivf(tier.emb, corpus_normalized=True)
    torch.cuda.synchronize()
    return tier, ivf, time.monotonic() - t0


def _ivf_queries(g, corpus, B):
    """Half near-duplicates of tier rows, half random directions."""
    import torch
    rows = torch.randint(0, corpus.shape[0], (B,), generator=g,
                         device="cuda")
    q = torch.randn((B, corpus.shape[1]), generator=g, device="cuda")
    near = corpus[rows] + 0.05 * q
    return torch.where((torch.arange(B, device="cuda") % 2 == 0)[:, None],
                       near, q).contiguous()


def compare_candidates(name, got, want, stats):
    """Candidate ids identical to the plain version's (order included),
    approximate scores within SCORE_TOL, absent ones as (NEG, -1)."""
    import torch
    from repro_torch.kernels.ivf_scan.ref import NEG
    v, i = got
    vr, ir = want
    need(v.shape == vr.shape and i.dtype == ir.dtype == torch.int32,
         f"{name}: {tuple(v.shape)}/{i.dtype} vs {tuple(vr.shape)}/"
         f"{ir.dtype}")
    need(torch.equal(i, ir), f"{name}: {int((i != ir).sum())} candidate "
         "ids differ from the plain version's")
    err = float((v - vr).abs().max()) if v.numel() else 0.0
    stats["max_abs_err"] = max(stats["max_abs_err"], err)
    need(err <= SCORE_TOL, f"{name}: score error {err:.3g} > {SCORE_TOL}")
    need(bool(((i >= 0) | (v == NEG)).all()), f"{name}: a real id with a "
         "NEG score or a pad id with a real score")


def _band_bytes(cids, cap, d):
    """Bytes of the distinct probed bands (codes, scale, id per slot)."""
    import torch
    return int(torch.unique(cids).numel()) * cap * (d + 8)


def _timing_sets(ivf, g):
    """N_BATCH_SETS query batches of 32 (normalized, with their probed
    clusters), so a timing loop does not find its bands in L2."""
    from repro_torch.kernels.ivf_scan.ref import _normalize, select_clusters
    out = []
    for _ in range(N_BATCH_SETS):
        q = _ivf_queries(g, ivf.corpus, 32)
        out.append((_normalize(q), select_clusters(
            q, ivf.centroids, IVF_NPROBE)[1].contiguous()))
    return out


def _band_composite(ivf, qn, cids):
    """One torch composite of the band scan's function (the yardstick:
    no single PyTorch call computes it): index_select of the probed
    bands, a bmm against the query, top-C."""
    import torch
    from repro_torch.kernels.ivf_scan.ref import NEG
    B = qn.shape[0]
    flat = cids.reshape(-1).long()
    g = ivf.codes.index_select(0, flat).view(B, -1, qn.shape[1])
    s = torch.bmm(g.float(), qn[:, :, None])[..., 0] \
        * ivf.scales.index_select(0, flat).view(B, -1)
    s = torch.where(ivf.row_ids.index_select(0, flat).view(B, -1) < 0,
                    NEG, s)
    return torch.topk(s, IVF_C)


def check_ivf_scan(ivf, quick: bool) -> dict:
    import torch
    from repro_torch.kernels.ivf_scan import kernel as K
    from repro_torch.kernels.ivf_scan.ops import ivf_scan
    from repro_torch.kernels.ivf_scan.ref import (band_scan_ref,
                                                  ivf_scan_ref,
                                                  select_clusters)

    g = torch.Generator(device="cuda").manual_seed(3)
    lay = (ivf.centroids, ivf.codes, ivf.scales, ivf.row_ids)
    stats = {"max_abs_err": 0.0}
    for B in ((32,) if quick else (1, 8, 32, 40)):
        q = _ivf_queries(g, ivf.corpus, B)
        before = K.launches
        got = ivf_scan(q, *lay, nprobe=IVF_NPROBE, n_candidates=IVF_C)
        need(K.launches == before + 1, f"ivf_scan B={B}: "
             f"{K.launches - before} launches, want 1")
        compare_candidates(f"ivf_scan B={B}", got,
                           ivf_scan_ref(q, *lay, IVF_NPROBE, IVF_C), stats)
    before = K.launches
    v0, i0 = ivf_scan(q[:0], *lay, nprobe=IVF_NPROBE, n_candidates=IVF_C)
    need(v0.shape == i0.shape == (0, IVF_C) and K.launches == before,
         "ivf_scan B=0: want empty outputs and no launch")
    # planted tie: one tier row's codes copied into two probed bands,
    # under ids N + 9 (first probe) and N + 2 (second): N + 2 must lead
    N = ivf.corpus.shape[0]
    r = int(ivf.row_ids[100, 0])
    q = ivf.corpus[r:r + 1].clone()
    cids = select_clusters(q, ivf.centroids, IVF_NPROBE)[1][0].tolist()
    kr, cr = (int(x) for x in torch.nonzero(ivf.row_ids == r)[0])
    codes, scales, ids = (t.clone() for t in lay[1:])
    for band, gid in ((cids[0], N + 9), (cids[1], N + 2)):
        free = torch.nonzero(ids[band] < 0)
        slot = int(free[0]) if len(free) else ids.shape[1] - 1
        codes[band, slot] = ivf.codes[kr, cr]
        scales[band, slot] = ivf.scales[kr, cr]
        ids[band, slot] = gid
    got = ivf_scan(q, ivf.centroids, codes, scales, ids,
                   nprobe=IVF_NPROBE, n_candidates=IVF_C)
    compare_candidates("ivf_scan planted tie", got, ivf_scan_ref(
        q, ivf.centroids, codes, scales, ids, IVF_NPROBE, IVF_C), stats)
    order = got[1][0].tolist()
    need(N + 2 in order and N + 9 in order
         and order.index(N + 9) == order.index(N + 2) + 1,
         f"ivf_scan planted tie: order {order[:6]}")
    pads = int((ivf.row_ids < 0).sum())
    del codes, scales, ids
    print(f"[kernels] ivf_scan: ids identical in B in (1, 8, 32, 40), "
          f"B=0 launches nothing, planted tie ok, {pads} pad slots in the "
          f"layout; max_abs_err {stats['max_abs_err']:.3g}")
    rec = {"name": "ivf_scan", "route": "cuda",
           "source": "src/repro_torch/csrc/ivf_scan.cu",
           "replaces": "src/repro/kernels/ivf_scan/kernel.py:108",
           "max_abs_err": stats["max_abs_err"]}
    if quick:
        return rec
    sets = _timing_sets(ivf, g)
    band = lay[1:]
    rec["ms"] = cuda_ms(lambda i: K.ivf_scan(
        *sets[i % N_BATCH_SETS], *band, IVF_C), 10 * N_BATCH_SETS)
    rec["plain_ms"] = cuda_ms(lambda i: band_scan_ref(
        *sets[i % N_BATCH_SETS], *band, IVF_C), N_BATCH_SETS)
    # no one PyTorch call computes the function: library_ms stays null,
    # and a torch composite is timed as the yardstick instead
    rec["library_ms"] = None
    rec["composite_ms"] = cuda_ms(lambda i: _band_composite(
        ivf, *sets[i % N_BATCH_SETS]), 2 * N_BATCH_SETS)
    rec["composite"] = "index_select + bmm + topk"
    B, (K_, cap, d) = 32, ivf.codes.shape
    bands = sum(_band_bytes(c, cap, d) for _, c in sets) / N_BATCH_SETS
    rec["bound_ms"], rec["bound_by"] = bound(
        bands + B * d * 4 + B * IVF_NPROBE * 4 + B * IVF_C * 8,
        2 * B * IVF_NPROBE * cap * d, "float32")
    return rec


def _dyn_tier(g, n, valid_frac):
    """A (n, d) normalized dynamic tier with a random valid mask."""
    import torch
    e = torch.randn((n, EMB_DIM), generator=g, device="cuda")
    valid = torch.rand((n,), generator=g, device="cuda") < valid_frac
    return e / e.norm(dim=1, keepdim=True), valid


def check_fused_serve(ivf, quick: bool) -> dict:
    import torch
    from repro_torch.kernels.fused_serve import kernel as K
    from repro_torch.kernels.fused_serve.ops import (fused_serve_probe,
                                                     pack_dyn_tiles)
    from repro_torch.kernels.fused_serve.ref import (fused_kernel_ref,
                                                     fused_serve_ref)

    g = torch.Generator(device="cuda").manual_seed(4)
    lay = (ivf.centroids, ivf.codes, ivf.scales, ivf.row_ids)
    stats = {"max_abs_err": 0.0}
    dyn, valid = _dyn_tier(g, DYN_CAPACITY, 0.7)
    cases = [(32, 0.7)] if quick else [(1, 0.7), (32, 0.7), (40, 0.7),
                                       (32, 0.0)]
    for B, frac in cases:
        emb, ok = (dyn, valid) if frac else (dyn, torch.zeros_like(valid))
        q = _ivf_queries(g, ivf.corpus, B)
        if frac:           # a few queries are live tier rows: exact hits
            live = torch.nonzero(ok)[:, 0]
            q[1::4] = emb[live[:len(q[1::4])]]
        before = K.launches
        got = fused_serve_probe(q, *lay, emb, ok, nprobe=IVF_NPROBE,
                                n_candidates=IVF_C, n_dyn_candidates=DYN_CD)
        need(K.launches == before + 1, f"fused_serve B={B}: "
             f"{K.launches - before} launches, want 1")
        want = fused_serve_ref(q, *lay, emb, ok, IVF_NPROBE, IVF_C, DYN_CD)
        name = f"fused_serve B={B}{'' if frac else ' all-invalid tier'}"
        compare_candidates(name + " static", got[:2], want[:2], stats)
        compare_candidates(name + " dynamic", got[2:], want[2:], stats)
        need(frac or bool((got[3] == -1).all()), f"{name}: a slot came "
             "back from an all-invalid tier")
    before = K.launches
    empty = fused_serve_probe(q[:0], *lay, dyn, valid, nprobe=IVF_NPROBE,
                              n_candidates=IVF_C, n_dyn_candidates=DYN_CD)
    need(empty[0].shape == (0, IVF_C) and empty[2].shape == (0, DYN_CD)
         and K.launches == before,
         "fused_serve B=0: want empty outputs and no launch")
    print(f"[kernels] fused_serve: ids identical in both halves for B in "
          f"(1, 32, 40) and an all-invalid tier, B=0 launches nothing; "
          f"max_abs_err {stats['max_abs_err']:.3g}")
    rec = {"name": "fused_serve", "route": "cuda",
           "source": "src/repro_torch/csrc/fused_serve.cu",
           "replaces": "src/repro/kernels/fused_serve/kernel.py:193",
           "max_abs_err": stats["max_abs_err"]}
    if quick:
        return rec
    sets = _timing_sets(ivf, g)
    tiles, tile_ids = pack_dyn_tiles(dyn, valid, DYN_CAPACITY)
    rest = (*lay[1:], tiles, tile_ids, IVF_C, DYN_CD)
    rec["ms"] = cuda_ms(lambda i: K.fused_serve(
        *sets[i % N_BATCH_SETS], *rest), 10 * N_BATCH_SETS)
    rec["plain_ms"] = cuda_ms(lambda i: fused_kernel_ref(
        *sets[i % N_BATCH_SETS], *rest), N_BATCH_SETS)
    flat_tiles = tiles.reshape(-1, EMB_DIM).float()
    dead = tile_ids.reshape(-1) < 0

    def composite(i):
        qn, cids = sets[i % N_BATCH_SETS]
        s = torch.where(dead, -2.0, qn @ flat_tiles.T)
        return _band_composite(ivf, qn, cids), torch.topk(s, DYN_CD)
    rec["library_ms"] = None
    rec["composite_ms"] = cuda_ms(composite, 2 * N_BATCH_SETS)
    rec["composite"] = "index_select + bmm + topk, matmul + topk"
    B, (K_, cap, d) = 32, ivf.codes.shape
    bands = sum(_band_bytes(c, cap, d) for _, c in sets) / N_BATCH_SETS
    rows = tiles.shape[0] * tiles.shape[1]
    rec["bound_ms"], rec["bound_by"] = bound(
        bands + rows * (2 * d + 4) + B * d * 4 + B * IVF_NPROBE * 4
        + B * (IVF_C + DYN_CD) * 8,
        2 * B * (IVF_NPROBE * cap + rows) * d, "float32")
    return rec


# ---------------------------------------------------------------------------
# phase 4: serve
# ---------------------------------------------------------------------------

def drive_run(name, service, path_kernels):
    """Serve SERVE_REQUESTS demo requests from 32 clients through the
    router, with every kernel count zeroed just before and read just
    after; hold the run to the checks every path shares. Returns
    (requests, results, counts, router stats)."""
    import torch
    from repro_torch.launch.serve import demo_requests, drive
    from repro_torch.serving.engine import EngineStats

    cfg = service.engine.cfg
    service.engine.stats = EngineStats()
    reqs = demo_requests(SERVE_REQUESTS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t1 = time.monotonic()
    results = drive(service, reqs, n_clients=32)
    service.policy.pool.drain(60.0)
    torch.cuda.synchronize()
    wall = time.monotonic() - t1
    counts = {n: m.launches for n, m in kernel_counters().items()}
    rs = service.router.stats()
    ps = service.policy.stats()
    es = service.engine.stats
    peak = torch.cuda.max_memory_allocated()
    print(f"[serve {name}] {SERVE_REQUESTS} requests in {wall:.2f}s: "
          f"static {rs['static_hit_rate']:.3f} dynamic "
          f"{rs['dynamic_hit_rate']:.3f} backend {rs['backend_rate']:.3f}; "
          f"judged {ps['judged']} approved {ps['approved']}; errors "
          f"{rs['errors']}; p50 {rs.get('p50_latency_ms')} ms p99 "
          f"{rs.get('p99_latency_ms')} ms; batches {rs['batches']} (mean "
          f"{rs['mean_batch_size']}); engine batches {es.batches} (failed "
          f"{service.frontend.failed_batches}) prefill rows {es.prefills} "
          f"decode steps {es.decode_steps} generated tokens "
          f"{es.generated_tokens}, engine wall prefill "
          f"{es.wall_prefill_s:.3f}s decode {es.wall_decode_s:.3f}s; peak "
          f"memory {peak / 2**30:.2f} GiB; lookups "
          f"{service.policy.describe_index()} / "
          f"{service.policy.describe_dyn_index()}")
    print(f"[serve {name}] kernel launches: {json.dumps(counts)}")
    need(all(r is not None for r in results), f"{name}: some requests got "
         "no result")
    need(rs["errors"] == 0, f"{name}: router errors {rs['errors']}: "
         f"{rs.get('last_error')}")
    need(service.frontend.failed_batches == 0,
         f"{name}: {service.frontend.failed_batches} engine batches failed")
    n_backend = sum(r.served_by == "backend" for r in results)
    need(es.prefills == n_backend, f"{name}: engine prefilled "
         f"{es.prefills} rows, the backend served {n_backend}")
    need(all(counts[k] > 0 for k in path_kernels),
         f"{name}: a kernel of the path never launched: {counts}")
    need(counts["flash_attention"] == cfg.n_layers * es.batches,
         f"{name}: flash launches {counts['flash_attention']} != layers x "
         f"prefills {cfg.n_layers * es.batches}")
    need(counts["decode_attention"] == cfg.n_layers * es.decode_steps,
         f"{name}: decode launches {counts['decode_attention']} != layers "
         f"x decode steps {cfg.n_layers * es.decode_steps}")
    for i, r in enumerate(results):
        # a miss against an empty dynamic tier scores -inf
        need(math.isfinite(r.similarity) or r.served_by == "backend"
             and r.similarity == -math.inf, f"{name} row {i}: similarity "
             f"{r.similarity}")
        # generated text may be empty: a random-weight model mostly
        # emits ids outside the byte tokenizer's range
        need(isinstance(r.answer, str), f"{name} row {i}: answer "
             f"{r.answer!r}")
        need(r.served_by != "static" or r.answer.startswith("[curated] "),
             f"{name} row {i}: static answer {r.answer!r}")
    return reqs, results, counts, rs


@contextlib.contextmanager
def plain_kernels():
    """Swap the IVF and fused kernel wrappers for their plain versions
    (same signatures); the swapped-in functions count no launches."""
    from repro_torch.kernels.fused_serve import kernel as fk
    from repro_torch.kernels.fused_serve.ref import fused_kernel_ref
    from repro_torch.kernels.ivf_scan import kernel as ik
    from repro_torch.kernels.ivf_scan.ref import band_scan_ref
    saved = ik.ivf_scan, fk.fused_serve
    ik.ivf_scan, fk.fused_serve = band_scan_ref, fused_kernel_ref
    try:
        yield
    finally:
        ik.ivf_scan, fk.fused_serve = saved


def lockstep_twin(pol):
    """A twin of ``pol`` (same static tier, layout, embedder and lookup
    settings, its own dynamic tier and index) that serves every batch
    right after ``pol`` does, with the plain versions of the kernels,
    its backend replaying ``pol``'s answers. Both judge pools are drained
    after each batch, so promotions land at the same points in both.
    Returns (twin, list of (results, twin results) per batch)."""
    from repro_torch.core.judge import OracleJudge
    from repro_torch.core.policy import KritesPolicy
    from repro_torch.index.segmented import SegmentedIndex

    answered, pairs = [], []
    backend = pol.backend_batch_fn

    def recorded(prompts):
        out = backend(prompts)
        answered.append((list(prompts), list(out)))
        return out

    def replay(prompts):
        want, out = answered.pop(0)
        need(want == list(prompts), "twin: its backend rows differ from "
             "the served policy's")
        return out

    dyn = pol.dyn_index
    if dyn is not None:
        dyn = SegmentedIndex(dyn.capacity, dyn.d, tail_rows=dyn.tail_rows,
                             compact_every=dyn.compact_every,
                             device=dyn.device)
    twin = KritesPolicy(pol.cfg, pol.static, pol.static_answers,
                        pol.embed_fn, backend_fn=None,
                        judge_fn=OracleJudge(), d=EMB_DIM,
                        backend_batch_fn=replay,
                        static_texts=pol.static_texts, index=pol.index,
                        dyn_index=dyn, fused=pol.fused, device=pol.device)
    serve = pol.serve_batch

    def serve_batch(prompts, metas=None):
        out = serve(prompts, metas)
        pol.pool.drain(60.0)
        with plain_kernels():
            pairs.append((out, twin.serve_batch(prompts, metas)))
            twin.pool.drain(60.0)
        return out

    pol.backend_batch_fn = recorded
    pol.serve_batch = serve_batch
    return twin, pairs


def check_twin(name, pairs, tau) -> None:
    """Every served decision equals the twin's (plain kernels, same
    layout); scores within SCORE_TOL."""
    rows = near = 0
    for out, tout in pairs:
        for a, b in zip(out, tout):
            rows += 1
            near += abs(b.similarity - tau) <= SCORE_TOL
            need((a.served_by, a.answer, a.static_origin)
                 == (b.served_by, b.answer, b.static_origin),
                 f"{name}: row {rows - 1} served {a.served_by} "
                 f"{a.answer!r}, the plain twin {b.served_by} {b.answer!r}")
            need(a.similarity == b.similarity
                 or abs(a.similarity - b.similarity) <= SCORE_TOL,
                 f"{name}: row {rows - 1} score {a.similarity} vs plain "
                 f"{b.similarity}")
    need(rows == SERVE_REQUESTS, f"{name}: the twin saw {rows} rows")
    print(f"[serve {name}] all {rows} decisions identical to the plain "
          f"twin's ({near} rows within {SCORE_TOL} of tau)")


def flat_agreement(name, pol, ivf, build_s, reqs) -> None:
    """How often the IVF static top-1 is the exact flat top-1 over the
    run's queries (recall@1), and the static-hit decision agreement, at
    the run's nprobe and at 4x that (measured after the run's counts
    were read)."""
    import torch
    from repro_torch.index.ivf import IVFIndex
    from repro_torch.kernels.simsearch.ref import simsearch_ref
    V = torch.as_tensor(pol.embed_fn.batch([p for p, _ in reqs]),
                        device="cuda")
    fs, fi = simsearch_ref(V, pol.static.emb, 1)
    tau = pol.cfg.tau_static
    print(f"[serve {name}] static tier IVF (K={ivf.codes.shape[0]}, "
          f"cap={ivf.codes.shape[1]}) built in {build_s:.2f}s")
    for nprobe in (IVF_NPROBE, 4 * IVF_NPROBE):
        vs, vi = IVFIndex(ivf, nprobe=nprobe, n_candidates=IVF_C).topk(V)
        print(f"[serve {name}] agreement with the flat path over the "
              f"run's {len(reqs)} queries at nprobe {nprobe}: static "
              f"top-1 id {float((fi == vi).float().mean()):.4f}, "
              f"static-hit decision "
              f"{float(((fs >= tau) == (vs >= tau)).float().mean()):.4f}")


def serve_phase(records: dict, ivf, build_s: float) -> None:
    import numpy as np
    import torch
    from repro_torch.configs import QWEN3_1_7B
    from repro_torch.kernels.simsearch.ref import simsearch_ref
    from repro_torch.launch.serve import build_service

    cfg = QWEN3_1_7B
    common = dict(device="cuda", static_rows=STATIC_ROWS, max_len=512,
                  max_new_tokens=16, router_batch=32, engine_batch=8)
    t0 = time.monotonic()
    service = build_service(cfg, **common)
    engine = service.engine
    try:
        n_params = sum(t.numel() for t in engine.params["layers"]
                       .values()) + sum(
            t.numel() for k, t in engine.params.items() if k != "layers")
        print(f"[serve] built in {time.monotonic() - t0:.1f}s: "
              f"{cfg.name} {cfg.n_layers}L d_model {cfg.d_model} "
              f"{cfg.dtype}, {n_params / 1e9:.3f} B params; static tier "
              f"{tuple(service.policy.static.emb.shape)} fp32")
        reqs, results, counts, rs = drive_run(
            "flat", service,
            ("simsearch", "flash_attention", "decode_attention"))
        # a router batch holds at most 32 rows: one simsearch launch each
        need(counts["simsearch"] == rs["batches"],
             f"simsearch launches {counts['simsearch']} != batches "
             f"{rs['batches']}")
        for k in ("simsearch", "flash_attention", "decode_attention"):
            records[k]["launches"] = counts[k]

        # served decisions against the plain static top-1 on the card
        pol = service.policy
        V = torch.as_tensor(pol.embed_fn.batch([p for p, _ in reqs]),
                            device="cuda")
        ref_s, _ = simsearch_ref(V, pol.static.emb, 1)
        ref_s = ref_s[:, 0].cpu().numpy()
        tau = pol.cfg.tau_static
        by = np.array([r.served_by for r in results])
        bad = [i for i in range(len(results))
               if (by[i] == "static") != (ref_s[i] >= tau)
               and abs(ref_s[i] - tau) > SCORE_TOL]
        need(not bad, f"served decisions disagree with the plain static "
             f"top-1 at rows {bad[:8]}")
        for i, r in enumerate(results):
            need(r.served_by != "static"
                 or abs(r.similarity - ref_s[i]) <= SCORE_TOL,
                 f"row {i}: served {r.similarity} vs plain {ref_s[i]}")
        print(f"[serve flat] decisions agree with the plain static top-1 "
              f"on all {len(results)} rows")
    finally:
        service.stop()
    del service
    check_model(engine)

    runs = (("ivf+segmented", "ivf_scan",
             dict(index="ivf", nprobe=IVF_NPROBE, dyn_index="segmented",
                  seg_rows=SEG_ROWS, compact_every=COMPACT_EVERY)),
            ("fused", "fused_serve", dict(fused=True, nprobe=IVF_NPROBE)))
    for name, kernel, kw in runs:
        service = build_service(cfg, engine=engine, ivf=ivf, **common, **kw)
        twin, pairs = lockstep_twin(service.policy)
        try:
            reqs, results, counts, rs = drive_run(
                name, service, (kernel, "flash_attention",
                                "decode_attention"))
            if kernel == "ivf_scan":
                st = service.policy.dyn_index_stats()
                print(f"[serve {name}] segmented index: seals "
                      f"{st['seals']} merges {st['merges']} segment scans "
                      f"{st['scans']} live {st['live']} tombstones "
                      f"{st['tombstones']}")
                need(st["seals"] > 0 and st["merges"] > 0,
                     f"{name}: the run sealed {st['seals']} and merged "
                     f"{st['merges']} times; want both > 0")
                need(counts["ivf_scan"] == rs["batches"] + st["scans"],
                     f"ivf_scan launches {counts['ivf_scan']} != router "
                     f"batches {rs['batches']} + segment scans "
                     f"{st['scans']}")
            else:
                need(counts["fused_serve"] == rs["batches"],
                     f"fused_serve launches {counts['fused_serve']} != "
                     f"router batches {rs['batches']}")
            records[kernel]["launches"] = counts[kernel]
            check_twin(name, pairs, service.policy.cfg.tau_static)
            flat_agreement(name, service.policy, ivf, build_s, reqs)
        finally:
            twin.pool.stop()
            service.stop()
        del service, twin, pairs


def check_model(engine) -> None:
    """The full-width model with the kernels against the same weights
    with plain attention: prefill logits and four greedy decode steps."""
    import torch
    from repro_torch.models import attention as plain
    from repro_torch.models import transformer as tr

    cfg, params = engine.cfg, engine.params
    toks = torch.stack([torch.from_numpy(engine.tok.encode(p, max_len=48))
                        for p in ("how do i fix my bike",
                                  "quick q: how do i sell my router")]
                       ).to("cuda", torch.int64)

    def run():
        logits, cache = tr.prefill(cfg, params, toks, max_len=64)
        outs = [logits]
        for _ in range(4):
            logits, cache = tr.decode_step(cfg, params, cache,
                                           torch.argmax(outs[-1], -1))
            outs.append(logits)
        return torch.stack(outs)

    with_kernels = run()
    saved = tr.attention, tr.decode_attention
    tr.attention = plain.causal_attention
    tr.decode_attention = lambda q, kc, vc, n: plain.decode_attention(
        q[:, None], kc, vc, n)[:, 0]
    try:
        with_plain = run()
    finally:
        tr.attention, tr.decode_attention = saved
    need(bool(with_kernels.isfinite().all()), "model logits not finite")
    rel = float((with_kernels - with_plain).abs().max()
                / with_plain.abs().max())
    agree = float((with_kernels.argmax(-1) == with_plain.argmax(-1))
                  .float().mean())
    print(f"[serve] model vs plain attention: max rel logit err "
          f"{rel:.3g}, greedy token agreement {agree:.3f}")
    need(rel <= LOGIT_REL_TOL, f"model logits rel err {rel:.3g} > "
         f"{LOGIT_REL_TOL}")


# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="build and check each kernel once; no timing, "
                         "no serving")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script runs on the card only", file=sys.stderr)
        return 2
    phase = "device"
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        need(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
        card = smi.stdout.strip().splitlines()[0]
        print(f"[device] {torch.cuda.get_device_name(0)}, torch "
              f"{torch.__version__}, CUDA {torch.version.cuda}")
        need(not torch.backends.cuda.matmul.allow_tf32,
             "fp32 matmuls must run in full fp32 (allow_tf32 is on)")

        phase = "build"
        from repro_torch.kernels import _build
        t0 = time.monotonic()
        _build.build(force=True)
        _build.library()
        n_src = len(list(_build.CSRC.glob("*.cu")))
        print(f"[build] {n_src} kernels, one nvcc per source in parallel "
              f"for sm_90a: {time.monotonic() - t0:.1f}s")
        _, ivf, build_s = build_static_ivf()
        K, cap, d = ivf.codes.shape
        print(f"[build] IVF over the {ivf.corpus.shape[0]}-row tier: "
              f"K={K} cap={cap} d={d}, codes "
              f"{ivf.codes.numel() / 2**20:.1f} MiB, built in "
              f"{build_s:.2f}s")

        phase = "kernels"
        records = {}
        for check in (check_simsearch, check_flash, check_decode,
                      functools.partial(check_ivf_scan, ivf),
                      functools.partial(check_fused_serve, ivf)):
            rec = check(args.quick)
            records[rec["name"]] = rec
            torch.cuda.synchronize()
            if not args.quick:
                lib = (f"library {rec['library_ms']:.4f} ms"
                       if rec["library_ms"] is not None else
                       f"no library call; composite ({rec['composite']}) "
                       f"{rec['composite_ms']:.4f} ms")
                print(f"[kernels] {rec['name']}: {rec['ms']:.4f} ms, plain "
                      f"{rec['plain_ms']:.4f} ms, {lib}, bound "
                      f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})")

        if not args.quick:
            phase = "serve"
            serve_phase(records, ivf, build_s)
        torch.cuda.synchronize()
    except Exception as e:  # noqa: BLE001 — report the phase, then fail
        print(f"chip_smoke: phase {phase} FAILED: {e!r}", file=sys.stderr)
        raise
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "composite_ms", "composite")
    print(json.dumps({"kernels": [{k: rec.get(k) for k in keys}
                                  for rec in records.values()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
