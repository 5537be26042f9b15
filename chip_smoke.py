#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py              # every phase; needs one CUDA card
    python3 chip_smoke.py --quick      # build, kernel checks, launcher
    python3 chip_smoke.py --against DIR [DIR ...]
        # build and kernel phases only: also time the IVF band scan and
        # the fused probe of each other checkout DIR (say the parent
        # commit from ``git archive``), in turns on the same inputs

Phases, each fatal on failure:

1. device: fail at once without CUDA; print the card's name and power
   limit as ``nvidia-smi`` gives them;
2. build: compile the six CUDA kernels from ``src/repro_torch/csrc``
   (one nvcc per source, in parallel), then build the 4,194,304-row
   demo static tier and its IVF layout (K = 8192, cap = 672);
3. kernels: hold simsearch, flash attention, decode attention, the IVF
   band scan, the fused two-tier probe and the embedding bag against
   their plain PyTorch versions on the card at the serving paths' shapes
   (planted ties and a near tie inside simsearch's screening margin,
   k 1/8/32, pads, empty and 40-row batches, an all-invalid dynamic
   tier; GQA groups 16, 5 and 3; Wide&Deep's deep and wide bags bit for
   bit at serve_p99 and serve_bulk, with edge cases; decode attention
   also against its split-KV plain version, lengths 0 to S), and time
   each beside its plain version, a library call or composite that
   computes the same function (used nowhere in the port) and the bound
   computed from the shapes. Every kernel and its library call or
   composite are timed in turns within the call (``turns_ms``: 9
   rounds, each a block of calls of each side, queued behind a spin
   kernel for the card's time and as launched): simsearch at B 32, 1
   and 8, attention at the serve shapes (decode at the serve run's own
   lengths, flash at B=1, S=1000 too), the IVF and fused probes, and the
   bag's four Wide&Deep calls;
4. launcher: ``python -m repro_torch.launch.serve`` as a user runs it,
   with no ``--device``: the card, 0 router errors, its kernels launched;
5. serve: full-width Qwen3-1.7B with random weights behind the
   4,194,304-row static tier, 128 requests from 32 concurrent clients
   through CacheRouter -> KritesPolicy.serve_batch -> BatchingFrontend
   -> LLMEngine, three times on one engine: the flat path (simsearch),
   the IVF + segmented path (ivf_scan) and the fused path
   (fused_serve). Each kernel's launches are counted over each run;
   the flat run's decisions are checked against the plain static top-1,
   the other two runs' against a twin policy served in lockstep with
   the plain versions on the same layout; the model's outputs are
   checked against the same model with plain attention;
6. serve recsys: full-width Wide&Deep (40 fields x 4 ids, embed 32,
   MLP 1024-512-256, a 4,001,792-row table) with random weights through
   ``launch/workloads.build_workload``: serve_p99 (8 batches of 512),
   serve_bulk (1 of 262,144) and retrieval_cand (4 queries against
   1,000,000 candidates, top-100); embedding_bag launches counted (2 a
   serve batch, 1 a query), outputs bit-identical to the same batches
   through the plain bag;
7. simulate: the trace simulator, which launches none of the kernels
   (every count stays 0): a dyadic 4,096-request trace through the
   blocked and the stepwise core on the card and on the CPU, every field
   identical; launches and device time a step under ``torch.profiler``;
   ``repro_torch.launch.calibrate --fixed`` (both presets at full scale,
   baseline and Krites in one sweep, the paper's invariants fatal, the
   rows printed beside ``EXPERIMENTS.md:36-47``) and its 64-config
   ``--sweep`` on lmarena_like, each with its wall time, microseconds per
   request per config and peak device memory.

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
WD_ARCH = "wide-deep"       # configs/other_archs.py, full width
WD_SEED = 0
RECSYS_RUNS = (("serve_p99", 8), ("serve_bulk", 1), ("retrieval_cand", 4))
TURN_ROUNDS = 9             # rounds of kernel vs library call, in turns
LAUNCHER_REQUESTS = 64
F32_TOL = 2e-5              # fp32 attention kernels vs the plain version


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


def turns_ms(fns: dict, calls: int, queued: bool = True) -> dict:
    """Time the callables ``fns`` (label -> fn(i)) in turns within one
    call. In each of TURN_ROUNDS rounds every callable runs a block of
    ``calls`` back-to-back calls between two CUDA events, one callable
    after the other (the order reversed every other round). ``queued``:
    a spin kernel holds the card while the block is enqueued, so the
    events time the card's work, not the host's launch rate; otherwise
    the block is timed as launched. Returns {label: {"median", "min",
    "max", "rounds"}} in ms per call."""
    import statistics
    import torch
    host = 0.0
    for fn in fns.values():          # warm up, and time the enqueue
        for i in range(3):
            fn(i)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(calls):
            fn(i)
        host = max(host, time.perf_counter() - t)
        torch.cuda.synchronize()
    spin = int(3 * host * 2e9)       # cycles: 3x the enqueue at 2 GHz
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    per = {k: [] for k in fns}
    for r in range(TURN_ROUNDS):
        for k in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            torch.cuda.synchronize()
            if queued:
                torch.cuda._sleep(spin)
            t0.record()
            for i in range(calls):
                fns[k](i)
            t1.record()
            t1.synchronize()
            per[k].append(t0.elapsed_time(t1) / calls)
    return {k: {"median": statistics.median(v), "min": min(v),
                "max": max(v), "rounds": v} for k, v in per.items()}


def kernel_counters():
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.embedding_bag import kernel as bk
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.fused_serve import kernel as uk
    from repro_torch.kernels.ivf_scan import kernel as ik
    from repro_torch.kernels.simsearch import kernel as sk
    return {"simsearch": sk, "flash_attention": fk,
            "decode_attention": dk, "ivf_scan": ik, "fused_serve": uk,
            "embedding_bag": bk}


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

    for B, k in (((32, 1),) if quick else
                 ((1, 1), (8, 1), (32, 1), (8, 8), (40, 32))):
        q = queries(B)
        before = K.launches
        got = K.simsearch(q, corpus, k)
        need(K.launches == before + -(-B // K.MAX_QUERIES),
             f"simsearch B={B}: {K.launches - before} launches")
        compare_topk(f"simsearch B={B} k={k}", q, corpus, got,
                     simsearch_ref(q, corpus, k), stats)
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
    # a near tie, closer than the kernel's screening margin (2^-8): an
    # exact copy of row 7 at 3,900,000 and a copy moved by 1 % of its
    # norm at row 11 (cosine ~ 1 - 5e-5)
    tied.copy_(corpus)
    tied[3_900_000] = corpus[7]
    tied[11] = corpus[7] + 0.01 * corpus[7].norm() / EMB_DIM ** 0.5 \
        * torch.randn((EMB_DIM,), generator=g, device="cuda")
    vn, it = K.simsearch(qt, tied, 3)
    _, itr = simsearch_ref(qt, tied, 3)
    need(it[0].tolist() == [7, 3_900_000, 11] == itr[0].tolist()
         and 0 < float(vn[0, 1] - vn[0, 2]) < 2 ** -8,
         f"simsearch near tie: kernel {it[0].tolist()} {vn[0].tolist()}, "
         f"plain {itr[0].tolist()}")
    del tied
    print(f"[kernels] simsearch: indices identical (B 1/8/32/40, k 1/8/32, "
          f"N={STATIC_ROWS} and 1000), max_abs_err "
          f"{stats['max_abs_err']:.3g}, planted tie order ok, near tie "
          f"{float(vn[0, 1] - vn[0, 2]):.3g} apart ok")
    rec = {"name": "simsearch", "route": "cuda",
           "source": "src/repro_torch/csrc/simsearch.cu",
           "replaces": "src/repro/kernels/simsearch/kernel.py:93",
           "max_abs_err": stats["max_abs_err"]}
    if quick:
        return rec
    # in turns against the library call on the same inputs, at the serve
    # run's B = 32 (one router batch) and at B = 1 and 8
    q = queries(32)
    qn = q / q.norm(dim=-1, keepdim=True)
    cn = corpus / corpus.norm(dim=-1, keepdim=True)
    for B in (32, 1, 8):
        qb, qnb = q[:B].contiguous(), qn[:B].contiguous()
        res = _turns(rec, f"simsearch B={B} N={STATIC_ROWS} k=1", {
            "kernel": lambda i: K.simsearch(qb, corpus, 1),
            "topk(q_n @ c_n.T)": lambda i: torch.topk(qnb @ cn.T, 1)}, 10)
        b_ms, b_by = bound((STATIC_ROWS * EMB_DIM + B * EMB_DIM) * 4 + B * 8,
                           2 * B * STATIC_ROWS * EMB_DIM, "float32")
        kern, lib = (res[x]["median"] for x in ("kernel",
                                                  "topk(q_n @ c_n.T)"))
        print(f"[kernels] simsearch B={B}: kernel/library {kern / lib:.3f}, "
              f"bound {b_ms:.4f} ms ({b_by}), kernel/bound "
              f"{kern / b_ms:.3f}")
        if B == 32:
            rec["ms"], rec["library_ms"] = kern, lib
            rec["bound_ms"], rec["bound_by"] = b_ms, b_by
            rec["plain_ms"] = cuda_ms(lambda i: simsearch_ref(qb, corpus, 1),
                                      5)
    return rec


def _turns(rec: dict, label: str, fns: dict, calls: int) -> dict:
    """Time ``fns`` in turns, queued (card time) and as launched; print
    both and keep them in ``rec["turns"][label]``. Returns the queued
    result."""
    res = {}
    for mode, how in (("card", "card time, queued"),
                      ("launched", "as launched")):
        r = res[mode] = turns_ms(fns, calls, queued=mode == "card")
        print(f"[kernels] turns {label} ({TURN_ROUNDS} rounds x {calls} "
              f"calls, {how}): " + "; ".join(
                  f"{k} {v['median']:.4f} ms [{v['min']:.4f}-"
                  f"{v['max']:.4f}]" for k, v in r.items()))
        print(f"[kernels] turns {label} rounds ({how}): " + json.dumps(
            {k: [round(x, 5) for x in v["rounds"]] for k, v in r.items()}))
    rec.setdefault("turns", {})[label] = {
        mode: {k: {x: round(v[x], 5) for x in ("median", "min", "max")}
               for k, v in r.items()} for mode, r in res.items()}
    return res["card"]


def check_flash(quick: bool) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.models.attention import causal_attention

    g = torch.Generator(device="cuda").manual_seed(1)
    H, Kv, D = 16, 8, 128

    def inputs(B, S, dtype=torch.bfloat16, h=H):
        def r(*shape):
            return torch.randn(shape, generator=g, device="cuda",
                               dtype=dtype)
        return r(B, S, h, D), r(B, S, Kv, D), r(B, S, Kv, D)

    err = 0.0
    # the serve shapes, long S, ragged tiles, and G = 1, 4 and 16 (h 8,
    # 32, 128)
    cases = [(8, 40, H), (8, 64, H), (1, 1000, H), (2, 1, H), (2, 17, H),
             (2, 65, H), (2, 33, Kv), (2, 33, 4 * Kv), (2, 33, 16 * Kv)]
    for B, S, h in cases:
        q, k, v = inputs(B, S, h=h)
        ref = causal_attention(q.float(), k.float(), v.float())
        for pair in (None, False, True):
            out = K.flash_attention(q, k, v, pair_tiles=pair)
            need(out.dtype == torch.bfloat16 and out.shape == q.shape,
                 f"flash B={B} S={S}: output {out.dtype} "
                 f"{tuple(out.shape)}")
            e = float((out.float() - ref).abs().max())
            need(math.isfinite(e) and e <= ATTN_TOL,
                 f"flash B={B} S={S} H={h} pair_tiles {pair}: max abs err "
                 f"{e:.3g} > {ATTN_TOL}")
            err = max(err, e)
    q, k, v = inputs(2, 65, torch.float32)
    e32 = float((K.flash_attention(q, k, v)
                 - causal_attention(q, k, v)).abs().max())
    need(e32 <= F32_TOL, f"flash fp32: max abs err {e32:.3g} > {F32_TOL}")
    print(f"[kernels] flash_attention: bf16 max_abs_err {err:.3g} over "
          f"{len(cases)} shapes (S 1-1000, G 1/2/4/16), q tiles paired, "
          f"unpaired and by default; fp32 {e32:.3g}")
    rec = {"name": "flash_attention", "route": "cuda",
           "source": "src/repro_torch/csrc/flash_attention.cu",
           "replaces": "src/repro/kernels/flash_attention/kernel.py:84",
           "max_abs_err": err}
    if quick:
        return rec

    def bound_of(B, S):
        pairs = S * (S + 1) // 2              # causal (query, key) pairs
        return bound(2 * (2 * B * S * H * D + 2 * B * S * Kv * D),
                     4 * B * H * D * pairs, "bfloat16")

    for B, S in ((8, 64), (1, 1000)):
        q, k, v = inputs(B, S)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        fns = {"kernel": lambda i: K.flash_attention(q, k, v)}
        for name, pair in (("unpaired", False), ("paired", True)):
            fns[f"kernel {name}"] = functools.partial(
                lambda i, pair: K.flash_attention(q, k, v, pair_tiles=pair),
                pair=pair)
        fns["sdpa"] = lambda i: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)
        res = _turns(rec, f"flash B={B} S={S}", fns, 50)
        b_ms, b_by = bound_of(B, S)
        print(f"[kernels] flash B={B} S={S}: kernel/SDPA "
              f"{res['kernel']['median'] / res['sdpa']['median']:.3f}, "
              f"bound {b_ms:.4f} ms ({b_by})")
        if (B, S) == (8, 64):
            rec["ms"] = res["kernel"]["median"]
            rec["library_ms"] = res["sdpa"]["median"]
            rec["bound_ms"], rec["bound_by"] = b_ms, b_by
            rec["plain_ms"] = cuda_ms(lambda i: causal_attention(q, k, v),
                                      50)
    return rec


def check_decode(quick: bool) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import kernel as K
    from repro_torch.kernels.decode_attention.ref import \
        decode_attention_split_ref
    from repro_torch.launch.serve import demo_requests
    from repro_torch.models.attention import decode_attention

    g = torch.Generator(device="cuda").manual_seed(2)
    B, S, Kv, G, D, L = 8, 512, 8, 2, 128, 28
    H = Kv * G
    C = K.CHUNK
    lengths = torch.tensor([1, 37, 64, 100, 255, 256, 400, 512],
                           dtype=torch.int32, device="cuda")
    # the serve runs' decode lengths: the engine's prompt (the longest
    # demo prompt in bytes + 2) plus 16 new tokens
    serve_len = max(len(p.encode()) + 2
                    for p, _ in demo_requests(SERVE_REQUESTS)) + 16
    serve_lengths = torch.full((B,), serve_len, dtype=torch.int32,
                               device="cuda")
    edge = torch.tensor([0, 1, C - 1, C, C + 1, S, 2 * C + 5, 3],
                        dtype=torch.int32, device="cuda")

    def r(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device="cuda", dtype=dtype)
    q = r(B, H, D)
    # one cache per layer, as the engine holds them: timing cycles over
    # them, so each call reads its cache from HBM, not from L2
    kc, vc = r(L, B, S, Kv, D), r(L, B, S, Kv, D)
    err = err_split = 0.0
    for name, lens in (("lengths 1..512", lengths),
                       (f"uniform {serve_len}", serve_lengths),
                       ("edge lengths", edge)):
        out = K.decode_attention(q, kc[0], vc[0], lens)
        need(out.dtype == torch.bfloat16 and out.shape == q.shape,
             f"decode: output {out.dtype} {tuple(out.shape)}")
        need(torch.equal(out, K.decode_attention(q, kc[0], vc[0], lens)),
             f"decode {name}: two calls differ")
        ref = decode_attention(q.float()[:, None], kc[0].float(),
                               vc[0].float(), lens)[:, 0]
        split = decode_attention_split_ref(q, kc[0], vc[0], lens, C)
        e = float((out.float() - ref).abs().max())
        es = float((out.float() - split).abs().max())
        need(math.isfinite(e) and e <= ATTN_TOL and es <= ATTN_TOL,
             f"decode {name}: max abs err {e:.3g} (plain), {es:.3g} "
             f"(split ref) > {ATTN_TOL}")
        err, err_split = max(err, e), max(err_split, es)
    # GQA groups past the serve model's 2: GLM-4-9B's 16 (one full m16
    # tile in bf16, two head tiles in fp32), Llama-4-Scout's 5, and 3
    for G_ in (16, 5, 3):
        qg = r(B, Kv * G_, D)
        out = K.decode_attention(qg, kc[0], vc[0], edge)
        ref = decode_attention(qg.float()[:, None], kc[0].float(),
                               vc[0].float(), edge)[:, 0]
        e = float((out.float() - ref).abs().max())
        need(out.shape == qg.shape and math.isfinite(e) and e <= ATTN_TOL,
             f"decode G={G_}: max abs err {e:.3g} > {ATTN_TOL}")
        err = max(err, e)
    q32, k32, v32 = r(B, H, D, dtype=torch.float32), \
        r(B, S, Kv, D, dtype=torch.float32), r(B, S, Kv, D,
                                               dtype=torch.float32)
    e32 = 0.0
    for q_ in (q32, r(B, Kv * 16, D, dtype=torch.float32),
               r(B, Kv * 5, D, dtype=torch.float32)):
        e32 = max(e32, float((K.decode_attention(q_, k32, v32, edge)
                              - decode_attention(q_[:, None], k32, v32,
                                                 edge)[:, 0]).abs().max()))
    need(e32 <= F32_TOL, f"decode fp32: max abs err {e32:.3g} > {F32_TOL}")
    print(f"[kernels] decode_attention: bf16 max_abs_err {err:.3g} vs the "
          f"plain version, {err_split:.3g} vs the split-KV plain version, "
          f"chunk {C}, lengths 1..512 / uniform {serve_len} / "
          f"edges {edge.tolist()}, G 2/16/5/3; fp32 {e32:.3g} (G 2/16/5); "
          f"repeat calls identical")
    rec = {"name": "decode_attention", "route": "cuda",
           "source": "src/repro_torch/csrc/decode_attention.cu",
           "replaces": "src/repro/kernels/decode_attention/kernel.py:95",
           "max_abs_err": max(err, err_split)}
    if quick:
        return rec
    qt = q[:, :, None, :]                                    # (B,H,1,D)
    kt, vt = kc.transpose(2, 3), vc.transpose(2, 3)          # (L,B,K,S,D)
    for name, lens in (("lengths 1..512", lengths),
                       (f"uniform {serve_len}", serve_lengths)):
        mask = (torch.arange(S, device="cuda")[None, :]
                < lens[:, None])[:, None, None, :]           # (B,1,1,S)
        fns = {"kernel": lambda i, lens=lens: K.decode_attention(
                   q, kc[i % L], vc[i % L], lens),
               "sdpa": lambda i, mask=mask: F.scaled_dot_product_attention(
                   qt, kt[i % L], vt[i % L], attn_mask=mask,
                   enable_gqa=True)}
        res = _turns(rec, f"decode B={B} S={S} {name}", fns, 56)
        live = int(lens.sum())
        b_ms, b_by = bound(2 * (2 * B * H * D + 2 * live * Kv * D) + 4 * B,
                           4 * live * H * D, "bfloat16")
        kern = res["kernel"]["median"]
        print(f"[kernels] decode {name}: kernel/SDPA "
              f"{kern / res['sdpa']['median']:.3f}, bound {b_ms:.4f} ms "
              f"({b_by})")
        if lens is lengths:
            rec["ms"], rec["library_ms"] = kern, res["sdpa"]["median"]
            rec["bound_ms"], rec["bound_by"] = b_ms, b_by
    rec["plain_ms"] = cuda_ms(lambda i: decode_attention(
        q[:, None], kc[i % L], vc[i % L], lengths), 56)
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


def load_other_kernels(root: Path) -> dict:
    """The ``ivf_scan`` and ``fused_serve`` wrappers of another checkout
    of the port at ``root``, imported beside this tree's (its
    ``repro_torch`` modules are swapped in for the import and out
    again) and built from that checkout's sources into its own
    ``build/``. Returns {kernel name: wrapper module}."""
    import importlib

    def ours():
        return [k for k in sys.modules if k.split(".")[0] == "repro_torch"]
    mine = {k: sys.modules.pop(k) for k in ours()}
    sys.path.insert(0, str(root / "src"))
    try:
        mods = {n: importlib.import_module(f"repro_torch.kernels.{n}.kernel")
                for n in ("ivf_scan", "fused_serve")}
        importlib.import_module("repro_torch.kernels._build").library()
    finally:
        sys.path.remove(str(root / "src"))
        for k in ours():
            del sys.modules[k]
        sys.modules.update(mine)
    return mods


def _same_ids(got, want) -> bool:
    import torch
    return all(torch.equal(g[1], w[1]) for g, w in zip(got, want))


def check_ivf_scan(ivf, others: dict, quick: bool) -> dict:
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
    probes = sum(c.numel() for _, c in sets)
    distinct = sum(int(torch.unique(c).numel()) for _, c in sets)
    print(f"[kernels] ivf_scan timing sets: {N_BATCH_SETS} batches of 32, "
          f"{distinct} distinct bands of {probes} probes "
          f"({distinct / probes:.4f})")
    # no one PyTorch call computes the function: library_ms stays null,
    # and a torch composite is timed in turns as the yardstick instead
    fns = {"kernel": lambda i: K.ivf_scan(*sets[i % N_BATCH_SETS], *band,
                                          IVF_C),
           "composite": lambda i: _band_composite(ivf,
                                                  *sets[i % N_BATCH_SETS])}
    for label, mods in others.items():
        fn = functools.partial(
            lambda i, k: k.ivf_scan(*sets[i % N_BATCH_SETS], *band, IVF_C),
            k=mods["ivf_scan"])
        print(f"[kernels] ivf_scan {label}: ids identical to this tree's: "
              f"{_same_ids([fn(0)], [fns['kernel'](0)])}")
        fns[label] = fn
    res = _turns(rec, "ivf_scan B=32", fns, 2 * N_BATCH_SETS)
    rec["ms"] = res["kernel"]["median"]
    rec["plain_ms"] = cuda_ms(lambda i: band_scan_ref(
        *sets[i % N_BATCH_SETS], *band, IVF_C), N_BATCH_SETS)
    rec["library_ms"] = None
    rec["composite_ms"] = res["composite"]["median"]
    rec["composite"] = "index_select + bmm + topk"
    B, (K_, cap, d) = 32, ivf.codes.shape
    bands = sum(_band_bytes(c, cap, d) for _, c in sets) / N_BATCH_SETS
    rec["bound_ms"], rec["bound_by"] = bound(
        bands + B * d * 4 + B * IVF_NPROBE * 4 + B * IVF_C * 8,
        2 * B * IVF_NPROBE * cap * d, "float32")
    _band_summary(rec, "ivf_scan B=32")
    return rec


def _band_summary(rec: dict, label: str) -> None:
    """One line: the kernel's card time and time as launched in turns
    against the composite's and the bound."""
    card, launched = (rec["turns"][label][m]["kernel"]["median"]
                      for m in ("card", "launched"))
    print(f"[kernels] {label}: kernel {card:.4f} ms card time, "
          f"{launched:.4f} as launched; kernel/composite "
          f"{card / rec['composite_ms']:.3f}, bound {rec['bound_ms']:.4f} "
          f"ms ({rec['bound_by']}), kernel/bound "
          f"{card / rec['bound_ms']:.2f}")


def _dyn_tier(g, n, valid_frac):
    """A (n, d) normalized dynamic tier with a random valid mask."""
    import torch
    e = torch.randn((n, EMB_DIM), generator=g, device="cuda")
    valid = torch.rand((n,), generator=g, device="cuda") < valid_frac
    return e / e.norm(dim=1, keepdim=True), valid


def check_fused_serve(ivf, others: dict, quick: bool) -> dict:
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
    flat_tiles = tiles.reshape(-1, EMB_DIM).float()
    dead = tile_ids.reshape(-1) < 0

    def composite(i):
        qn, cids = sets[i % N_BATCH_SETS]
        s = torch.where(dead, -2.0, qn @ flat_tiles.T)
        return _band_composite(ivf, qn, cids), torch.topk(s, DYN_CD)
    fns = {"kernel": lambda i: K.fused_serve(*sets[i % N_BATCH_SETS],
                                             *rest),
           "composite": composite}
    for label, mods in others.items():
        fn = functools.partial(
            lambda i, k: k.fused_serve(*sets[i % N_BATCH_SETS], *rest),
            k=mods["fused_serve"])
        got, want = fn(0), fns["kernel"](0)
        print(f"[kernels] fused_serve {label}: ids identical to this "
              f"tree's: {_same_ids([got[:2], got[2:]], [want[:2], want[2:]])}")
        fns[label] = fn
    res = _turns(rec, "fused_serve B=32", fns, 2 * N_BATCH_SETS)
    rec["ms"] = res["kernel"]["median"]
    rec["plain_ms"] = cuda_ms(lambda i: fused_kernel_ref(
        *sets[i % N_BATCH_SETS], *rest), N_BATCH_SETS)
    rec["library_ms"] = None
    rec["composite_ms"] = res["composite"]["median"]
    rec["composite"] = "index_select + bmm + topk, matmul + topk"
    B, (K_, cap, d) = 32, ivf.codes.shape
    bands = sum(_band_bytes(c, cap, d) for _, c in sets) / N_BATCH_SETS
    rows = tiles.shape[0] * tiles.shape[1]
    rec["bound_ms"], rec["bound_by"] = bound(
        bands + rows * (2 * d + 4) + B * d * 4 + B * IVF_NPROBE * 4
        + B * (IVF_C + DYN_CD) * 8,
        2 * B * (IVF_NPROBE * cap + rows) * d, "float32")
    _band_summary(rec, "fused_serve B=32")
    return rec


def _wd_bags(cfg, B: int, seed: int):
    """One Wide&Deep batch of B rows from ``recsys_batches``, as the model
    hands it to the bag: (B * n_sparse, m) int32 global ids, and the mean
    (deep table) and sum (wide table) weights."""
    from repro_torch.data.recsys_data import recsys_batches
    from repro_torch.models import recsys
    b = recsys.batch_from_numpy(next(recsys_batches(cfg, B, seed)), "cuda")
    gids = recsys._wd_field_ids(cfg, b["sparse_ids"])
    m = cfg.multi_hot
    return (gids.reshape(-1, m).contiguous(),
            *(recsys.bag_weights(gids, b["sparse_mask"], mode)
              .reshape(-1, m).contiguous() for mode in ("mean", "sum")))


def _time_bag(label, table, sets, iters, bag_rec, groups):
    """Kernel (with the path's ``groups``, Wide&Deep's fields) and
    ``F.embedding_bag`` (the library call, used nowhere in the port, on
    the same bags in their order) over the (ids, weights) sets, in
    turns, the plain version, and the bound: the distinct rows the ids
    need (each input read once), ids, weights and the output; beside it
    the bound if every gathered row were read. The turns go into
    ``bag_rec["turns"]``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.embedding_bag import kernel as K
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    n = len(sets)
    longs = [i.long() for i, _ in sets]
    res = _turns(bag_rec, f"embedding_bag {label}", {
        "kernel": lambda i: K.embedding_bag(table, *sets[i % n], groups),
        "F.embedding_bag": lambda i: F.embedding_bag(
            longs[i % n], table, per_sample_weights=sets[i % n][1],
            mode="sum")}, iters)
    rec = {"call": label, "ms": res["kernel"]["median"],
           "plain_ms": cuda_ms(lambda i: embedding_bag_ref(
               table, *sets[i % n]), max(2, iters // 10), warmup=1),
           "library_ms": res["F.embedding_bag"]["median"]}
    (B, m), d = sets[0][0].shape, table.shape[1]
    rows = sum(int(torch.unique(i).numel()) for i, _ in sets) / n
    rest = B * m * 8 + B * d * 4
    rec["bound_ms"], rec["bound_by"] = bound(
        rows * d * table.element_size() + rest, 2 * B * m * d, "float32")
    rec["gathered_bound_ms"], _ = bound(
        B * m * d * table.element_size() + rest, 2 * B * m * d, "float32")
    rec["distinct_rows"] = rows
    print(f"[kernels] embedding_bag {label}: {rec['ms']:.4f} ms, plain "
          f"{rec['plain_ms']:.4f} ms, F.embedding_bag "
          f"{rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
          f"({rec['bound_by']}; {rows:.0f} distinct rows), "
          f"{rec['gathered_bound_ms']:.4f} ms if every gathered row were "
          f"read")
    return rec


def check_embedding_bag(quick: bool) -> dict:
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels.embedding_bag import kernel as K
    from repro_torch.kernels.embedding_bag.ops import embedding_bag
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    from repro_torch.models.recsys import _table_rows

    cfg = get_arch(WD_ARCH)
    V, d = _table_rows(cfg.n_sparse * cfg.sparse_vocab), cfg.embed_dim
    g = torch.Generator(device="cuda").manual_seed(5)
    deep = torch.randn((V, d), generator=g, device="cuda")
    wide = torch.randn((V, 1), generator=g, device="cuda")
    ids, w_mean, w_sum = _wd_bags(cfg, 512, WD_SEED)     # 20,480 bags
    ids[0, 0], ids[-1, -1] = 0, V - 1          # first and last table rows
    w_mean[2] = 0.0                            # an all-zero bag
    names = []

    def exact(name, table, i, w, groups=1):
        before = K.launches
        out = K.embedding_bag(table, i, w, groups)
        ref = embedding_bag_ref(table, i, w)
        torch.cuda.synchronize()
        need(K.launches == before + 1, f"embedding_bag {name}: "
             f"{K.launches - before} launches, want 1")
        need(out.shape == ref.shape and out.dtype == torch.float32
             and bool(ref.isfinite().all()),
             f"embedding_bag {name}: {out.dtype} {tuple(out.shape)}")
        err = float((out - ref).abs().max())
        need(torch.equal(out, ref), f"embedding_bag {name}: not "
             f"bit-identical to the plain version (max abs err {err:.3g})")
        names.append(name)

    # the path's calls name Wide&Deep's fields as groups; at serve_bulk
    # the kernel takes the bags two fields at a time (table and gathered
    # rows both exceed half the L2), at serve_p99 in bag order
    F_ = cfg.n_sparse
    bulk_ids, bulk_mean, bulk_sum = _wd_bags(cfg, 262144, WD_SEED)
    exact(f"deep V={V} d={d} B={ids.shape[0]} m={ids.shape[1]}", deep, ids,
          w_mean, F_)
    exact(f"deep serve_bulk B={bulk_ids.shape[0]}, field order", deep,
          bulk_ids, bulk_mean, F_)
    exact("wide d=1", wide, ids, w_sum, F_)
    exact("wide d=1 serve_bulk", wide, bulk_ids, bulk_sum, F_)
    exact("deep bf16 table serve_bulk, field order",
          deep.to(torch.bfloat16), bulk_ids, bulk_mean, F_)
    for Vs, ds, Bs, ms in ((37, 24, 5, 7), (100, 16, 1, 1), (1, 8, 2, 2),
                           (512, 128, 16, 8)):
        exact(f"V={Vs} d={ds} B={Bs} m={ms}",
              torch.randn((Vs, ds), generator=g, device="cuda"),
              torch.randint(0, Vs, (Bs, ms), generator=g, device="cuda",
                            dtype=torch.int32),
              torch.rand((Bs, ms), generator=g, device="cuda"))
    before = K.launches
    empty = embedding_bag(deep, ids[:0], w_mean[:0])
    need(empty.shape == (0, d) and K.launches == before,
         "embedding_bag B=0: want a (0, d) output and no launch")
    print(f"[kernels] embedding_bag: bit-identical to the plain version in "
          f"{len(names)} cases ({'; '.join(names)}), ids 0 and V-1 and an "
          f"all-zero bag included; B=0 launches nothing; max_abs_err 0")
    rec = {"name": "embedding_bag", "route": "cuda",
           "source": "src/repro_torch/csrc/embedding_bag.cu",
           "replaces": "src/repro/kernels/embedding_bag/kernel.py:50",
           "max_abs_err": 0.0}
    if quick:
        return rec
    # serve_p99 calls cycle N_BATCH_SETS batches, so their rows come from
    # HBM as a new request's would; serve_bulk's one batch exceeds the L2
    p99 = [_wd_bags(cfg, 512, WD_SEED + 1 + s) for s in range(N_BATCH_SETS)]
    calls = [_time_bag("serve_p99 deep", deep,
                       [(i, wm) for i, wm, _ in p99], 2 * N_BATCH_SETS, rec,
                       F_),
             _time_bag("serve_p99 wide", wide,
                       [(i, ws) for i, _, ws in p99], 2 * N_BATCH_SETS, rec,
                       F_)]
    del p99
    calls += [_time_bag("serve_bulk deep", deep, [(bulk_ids, bulk_mean)], 5,
                        rec, F_),
              _time_bag("serve_bulk wide", wide, [(bulk_ids, bulk_sum)], 5,
                        rec, F_)]
    rec.update({k: calls[0][k] for k in ("ms", "plain_ms", "library_ms",
                                         "bound_ms", "bound_by")})
    rec["calls"] = calls
    return rec


# ---------------------------------------------------------------------------
# phase 4: the launcher as a user runs it
# ---------------------------------------------------------------------------

def launcher_phase() -> None:
    """``python -m repro_torch.launch.serve --requests N`` with no
    ``--device``: the card, the smoke config shaped for it (head dim 64)
    and the CUDA kernels. Every count is zeroed just before and read
    just after; the run must end with 0 router errors and every kernel
    of its path launched."""
    from repro_torch.launch import serve
    reset_counts()
    t0 = time.monotonic()
    stats = serve.main(["--requests", str(LAUNCHER_REQUESTS)])
    counts = {n: m.launches for n, m in kernel_counters().items()}
    print(f"[launcher] python -m repro_torch.launch.serve --requests "
          f"{LAUNCHER_REQUESTS} (no --device): {time.monotonic() - t0:.1f}s, "
          f"errors {stats['errors']}, kernel launches {json.dumps(counts)}")
    need(stats["errors"] == 0, f"launcher: router errors {stats['errors']}: "
         f"{stats.get('last_error')}")
    need(all(counts[k] > 0 for k in ("simsearch", "flash_attention",
                                     "decode_attention")),
         f"launcher: a kernel of its path never launched: {counts}")


# ---------------------------------------------------------------------------
# phase 5: serve
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


@contextlib.contextmanager
def plain_bag():
    """Swap the embedding-bag kernel wrapper for its plain version (same
    signature); the swapped-in function counts no launches."""
    from repro_torch.kernels.embedding_bag import kernel as bk
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    saved = bk.embedding_bag
    bk.embedding_bag = embedding_bag_ref
    try:
        yield
    finally:
        bk.embedding_bag = saved


def _same_outputs(name, got, want, n_items) -> None:
    """Serve scores, or retrieval (scores, ids), bit-identical to the
    plain twin's, finite and of the expected shape."""
    import torch
    if isinstance(got, tuple):
        (v, i), (vr, ir) = got, want
        need(v.shape == i.shape == (1, 100) and i.dtype == torch.int32,
             f"{name}: retrieval {tuple(v.shape)} {i.dtype}")
        need(torch.equal(i, ir), f"{name}: retrieval ids differ from the "
             "plain twin's")
        need(bool((i >= 1).all() and (i <= n_items).all()),
             f"{name}: ids outside 1..{n_items}")
        need(bool((v[:, :-1] >= v[:, 1:]).all()), f"{name}: scores not "
             "in descending order")
        got, want = v, vr
    need(bool(got.isfinite().all()), f"{name}: non-finite scores")
    need(torch.equal(got, want), f"{name}: scores differ from the plain "
         f"twin's (max abs err {float((got - want).abs().max()):.3g})")


def serve_recsys(records: dict) -> None:
    """Full-width Wide&Deep through ``launch/workloads.build_workload``:
    serve_p99 (8 batches of 512), serve_bulk (1 of 262,144) and
    retrieval_cand (4 single queries against 1,000,000 candidates,
    top-100), each after one warm-up call, with every kernel count zeroed
    just before and read just after; then the same batches with the
    plain bag (bit-identical outputs), and a smoke-size batch on the card
    against the CPU."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch, get_shape, smoke_config
    from repro_torch.launch.workloads import build_recsys, build_workload

    n_items = get_arch(WD_ARCH).n_items
    launches = 0
    for shape, n in RECSYS_RUNS:
        name = f"serve recsys {WD_ARCH}:{shape}"
        t0 = time.monotonic()
        wl = build_workload(WD_ARCH, shape, device="cuda", seed=WD_SEED)
        params, first = wl.args
        batches = [first] + [next(wl.batches) for _ in range(n - 1)]
        wl.fn(params, first)
        torch.cuda.synchronize()
        build_s = time.monotonic() - t0
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_counts()
        outs, ms = [], []
        for b in batches:
            t1 = time.monotonic()
            outs.append(wl.fn(params, b))
            torch.cuda.synchronize()
            ms.append(1e3 * (time.monotonic() - t1))
        counts = {k: m.launches for k, m in kernel_counters().items()}
        peak = torch.cuda.max_memory_allocated()
        per = 1 if shape == "retrieval_cand" else 2
        need(counts["embedding_bag"] == per * n, f"{name}: embedding_bag "
             f"launches {counts['embedding_bag']}, want {per} x {n}")
        need(all(v == 0 for k, v in counts.items() if k != "embedding_bag"),
             f"{name}: other kernels launched: {counts}")
        launches += counts["embedding_bag"]
        with plain_bag():
            plain = [wl.fn(params, b) for b in batches]
        torch.cuda.synchronize()
        for j, (o, p) in enumerate(zip(outs, plain)):
            if shape != "retrieval_cand":
                need(o.shape == (batches[j]["sparse_ids"].shape[0], 1),
                     f"{name}: scores {tuple(o.shape)}")
            _same_outputs(f"{name} batch {j}", o, p, n_items)
        rate = wl.model_flops * n / (sum(ms) / 1e3)
        lat = (f"latency per batch p50 {np.percentile(ms, 50):.3f} ms p99 "
               f"{np.percentile(ms, 99):.3f} ms" if n > 1 else
               f"wall {ms[0]:.3f} ms")
        if shape == "retrieval_cand":
            lat = (f"wall per query {', '.join(f'{x:.3f}' for x in ms)} ms "
                   f"(mean {np.mean(ms):.3f})")
        gib = 2 ** 30
        print(f"[{name}] {n} x {first['sparse_ids'].shape[0]} rows: {lat}; "
              f"embedding_bag launches {counts['embedding_bag']}; peak "
              f"memory {peak / gib:.2f} GiB, {(peak - base) / gib:.2f} GiB "
              f"above the {base / gib:.2f} GiB held before the run (earlier "
              f"phases' data, the parameters, the batches); model "
              f"{wl.model_flops:.4g} flop a call, {rate / 1e12:.3f} TFLOP/s;"
              f" built and warmed up in {build_s:.1f}s; outputs "
              f"bit-identical to the plain twin's")
        del wl, params, batches, first, outs, plain
        torch.cuda.empty_cache()
    records["embedding_bag"]["launches"] = launches

    # small input: the card (kernel) against the CPU (plain), same weights
    cfg = smoke_config(WD_ARCH)
    wl = build_recsys(cfg, get_shape(cfg, "serve_p99"), device="cuda")
    params, batch = wl.args
    cpu = {k: ([{n: t.cpu() for n, t in l.items()} for l in v]
               if k == "mlp" else v.cpu()) for k, v in params.items()}
    got = wl.fn(params, batch).cpu()
    want = wl.fn(cpu, {k: v.cpu() for k, v in batch.items()})
    err = float((got - want).abs().max())
    need(err <= SCORE_TOL, f"smoke Wide&Deep card vs CPU: {err:.3g}")
    print(f"[serve recsys] smoke Wide&Deep serve_p99 on the card vs the "
          f"CPU, same weights: max abs err {err:.3g}")


# ---------------------------------------------------------------------------
# phase 7: the trace simulator
# ---------------------------------------------------------------------------

SIM_DYADIC_REQUESTS = 4096
SIM_PROFILE_REQUESTS = 192    # profiled prefix: three 64-step windows
# EXPERIMENTS.md:36-47, the operating points at the pinned t* (measured
# with jax 0.4.x on a CPU): static-origin, total hit, error, judge calls,
# promotions
SIM_TABLE = {
    "lmarena_like": {"baseline": (0.087, 0.340, 0.012, 0, 0),
                     "krites": (0.237, 0.340, 0.012, 36_600, 8_600)},
    "search_like": {"baseline": (0.031, 0.212, 0.0008, 0, 0),
                    "krites": (0.200, 0.212, 0.0008, 96_000, 31_300)},
}
SIM_INVARIANT_TOL = 1e-3     # the paper's invariants, Krites vs baseline


def _dyadic_sim_inputs():
    """A 4,096-request lmarena_like cut with every embedding rounded to a
    multiple of 2^-8: each similarity is then exact in fp32 in any
    summation order, so the card and the CPU must agree on every field.
    The configs switch on, between them, the L1, TTLs with volatile
    bypass, drift, rewrites, judge flips and rate limits."""
    import dataclasses
    import numpy as np
    from repro_torch.core.tiers import CacheConfig
    from repro_torch.data.synth_traces import LMARENA_LIKE, build_benchmark
    n = SIM_DYADIC_REQUESTS
    b = build_benchmark(dataclasses.replace(
        LMARENA_LIKE, n_requests=n * 5 // 4, n_classes=1200, n_topics=24,
        volatile_frac=0.3))
    r = np.random.default_rng(0)

    def dy(x):
        return (np.round(x.astype(np.float64) * 256) / 256).astype(
            np.float32)
    args = (dy(b.static_emb), b.static_cls, dy(b.eval_emb[:n]),
            b.eval_cls[:n])
    kw = dict(volatile=b.eval_volatile[:n], key_id=b.eval_key[:n],
              drift_every=256, rewritable=r.random(n) < 0.5,
              judge_flip=r.random(n) < 0.05)
    cfgs = [CacheConfig(0.88, 0.88, capacity=512, judge_latency=8),
            CacheConfig(0.88, 0.90, sigma_min=0.5, capacity=256,
                        judge_latency=8, l1=True, volatile_bypass=True,
                        ttl_volatile=60, ttl_stable=400),
            CacheConfig(0.86, 0.90, sigma_min=0.3, capacity=128,
                        judge_latency=32, judge_rate=0.5, rewrite=True,
                        rewrite_rate=0.05),
            CacheConfig(0.90, 0.90, capacity=512, judge_latency=12,
                        l1=True, ttl_stable=300)]
    return args, kw, cfgs, [True, True, True, False]


def _profile_steps(run, steps: int) -> str:
    """Launches and device time per step of ``run()`` under
    ``torch.profiler``, and the device's idle share of the wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        run()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    ev = prof.key_averages()
    launches = sum(e.count for e in ev if e.key == "cudaLaunchKernel")
    dev_us = sum(e.self_device_time_total for e in ev
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    if not dev_us:
        return (f"{launches / steps:.1f} cudaLaunchKernel a step; device "
                f"time not measured (the profiler saw no device events); "
                f"wall {1e6 * wall / steps:.1f} us a step (profiled)")
    return (f"{launches / steps:.1f} cudaLaunchKernel a step, device busy "
            f"{dev_us / steps:.1f} us a step against a wall of "
            f"{1e6 * wall / steps:.1f} us a step (profiled): the device is "
            f"idle {100 * (1 - dev_us / (1e6 * wall)):.1f} % of the wall")


def simulate_phase(card: str) -> None:
    """The trace simulator on the card, through the entry points a user
    calls: (a) a dyadic trace through both cores on the card and on the
    CPU, every field identical; (b) ``python -m
    repro_torch.launch.calibrate --fixed`` (its ``main``, no ``--device``):
    both presets at full scale, baseline and Krites in one sweep, held to
    the paper's invariants and printed beside ``EXPERIMENTS.md:36-47``;
    (c) its ``--sweep`` grid (64 configs) on lmarena_like. The simulator
    launches none of the port's kernels: every count stays 0."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core import simulate as sim
    from repro_torch.core.tiers import CacheConfig
    from repro_torch.data.synth_traces import LMARENA_LIKE, build_benchmark
    from repro_torch.launch import calibrate

    t_phase = time.monotonic()
    reset_counts()
    args, kw, cfgs, krs = _dyadic_sim_inputs()
    n = SIM_DYADIC_REQUESTS
    for core, lats in (("blocked", [16] * 4), ("stepwise", [8, 8, 32, 12])):
        sweep = sim.sweep_from_configs(
            [dataclasses.replace(c, judge_latency=lt)
             for c, lt in zip(cfgs, lats)], krs)
        t0 = time.monotonic()
        got = sim.simulate_sweep(*args, sweep, device="cuda", **kw)
        torch.cuda.synchronize()
        t1 = time.monotonic()
        want = sim.simulate_sweep(*args, sweep, device="cpu", **kw)
        t2 = time.monotonic()
        for name, g, w in zip(sim.SimResult._fields, got, want):
            need(g.device.type == "cuda" and torch.equal(g.cpu(), w),
                 f"simulate dyadic {core}: field {name} differs between "
                 "the card and the CPU")
        sb = want.served_by
        seen = {"promotions": int(want.promotions.sum()),
                "L1 hits": int((sb == sim.L1_HIT).sum()),
                "rewritten hits": int((sb == sim.REWRITTEN_HIT).sum()),
                "bypassed": int(want.bypassed.sum()),
                "ttl evictions": int(want.ttl_evicted.sum()),
                "stale serves": int(want.stale.sum()),
                "enqueues dropped": int(want.enq_dropped.sum())}
        need(all(seen.values()), f"simulate dyadic {core}: a feature was "
             f"never exercised: {seen}")
        print(f"[simulate] dyadic {n} requests x 4 configs, {core} core "
              f"(latencies {lats}): every SimResult field identical on the "
              f"card and the CPU; card {t1 - t0:.2f}s, CPU {t2 - t1:.2f}s; "
              f"{json.dumps(seen)}")

    # launches a step and the device's share, on a profiled prefix of
    # the operating point (flag-free, K = 2, C = 8192) and of the
    # stepwise core on the dyadic trace
    b = build_benchmark(LMARENA_LIKE)
    m = SIM_PROFILE_REQUESTS
    op = CacheConfig(0.88, 0.88, capacity=8192, judge_latency=64)
    for label, run in (
            ("blocked core, operating point (K=2, C=8192)",
             lambda: sim.simulate_sweep(
                 b.static_emb, b.static_cls, b.eval_emb[:m],
                 b.eval_cls[:m], sim.sweep_from_configs([op, op],
                                                        [False, True]))),
            ("stepwise core, dyadic configs (K=4)",
             lambda: sim.simulate_sweep(
                 *(a[:m] if i > 1 else a for i, a in enumerate(args)),
                 sim.sweep_from_configs(
                     [dataclasses.replace(c, judge_latency=lt) for c, lt
                      in zip(cfgs, [8, 8, 32, 12])], krs),
                 **{k: (v[:m] if isinstance(v, np.ndarray) else v)
                    for k, v in kw.items()}))):
        run()
        print(f"[simulate] {label}, {m} requests: "
              f"{_profile_steps(run, m)}; {card}")
    del b

    # (b) the operating-point table, as a user runs it
    t0 = time.monotonic()
    table = calibrate.main(["--fixed"])
    table_s = time.monotonic() - t0
    for wl, r in table.items():
        base, kr = r["baseline"], r["krites"]
        need(r["device"].startswith("cuda"), f"{wl}: ran on {r['device']}")
        for row in (base, kr):
            need(all(np.isfinite(v) for v in row.values()),
                 f"{wl}: non-finite summary {row}")
        for k in ("total_hit_rate", "static_hit_rate"):
            need(abs(kr[k] - base[k]) <= SIM_INVARIANT_TOL,
                 f"{wl}: Krites {k} {kr[k]} vs baseline {base[k]}")
        need(kr["error_rate"] <= base["error_rate"] + SIM_INVARIANT_TOL,
             f"{wl}: Krites error {kr['error_rate']} vs baseline "
             f"{base['error_rate']}")
        need(kr["static_origin_rate"] > base["static_origin_rate"],
             f"{wl}: Krites static-origin {kr['static_origin_rate']} not "
             f"above the baseline's {base['static_origin_rate']}")
        for pol, row in (("baseline", base), ("krites", kr)):
            so, hit, err, jc, pr = SIM_TABLE[wl][pol]
            print(f"[simulate] {wl} t*={r['tstar']} {pol}: static-origin "
                  f"{row['static_origin_rate']:.4f} (table {so}), total hit "
                  f"{row['total_hit_rate']:.4f} (table {hit}), error "
                  f"{row['error_rate']:.4f} (table {err}), judge calls "
                  f"{row['judge_calls']} (table {jc}), promotions "
                  f"{row['promotions']} (table {pr})")
        print(f"[simulate] {wl}: {base['requests']} requests x 2 configs "
              f"in {r['wall_s']:.2f}s, {r['us_per_request_config']:.2f} us "
              f"per request per config, peak device memory "
              f"{r['peak_device_bytes'] / 2**20:.1f} MiB above what was "
              f"held before; invariants hold "
              f"(|d total hit|, |d static hit| <= {SIM_INVARIANT_TOL}, "
              f"error not above, static-origin above); {card}")
    print(f"[simulate] calibrate --fixed: {table_s:.1f}s in all (trace "
          f"generation included), wrote results/torch_table1_full.json")

    # (c) the 8 x 8 grid
    t0 = time.monotonic()
    sw = calibrate.main(["--sweep", "lmarena_like"])["lmarena_like"]
    rows = sw["configs"]
    need(len(rows) == 64 and sw["pareto"], f"sweep: {len(rows)} configs, "
         f"pareto {sw['pareto']}")
    need(all(0.0 <= row[k] <= 1.0 for row in rows for k in
             ("total_hit_rate", "error_rate", "static_origin_rate")),
         "sweep: a rate outside [0, 1]")
    print(f"[simulate] sweep lmarena_like: 64 configs x {rows[0]['requests']}"
          f" requests in {sw['wall_s']:.2f}s, "
          f"{sw['us_per_request_config']:.3f} us per request per config, "
          f"peak device memory {sw['peak_device_bytes'] / 2**20:.1f} MiB "
          f"above what was held before, "
          f"{len(sw['pareto'])} Pareto points; {time.monotonic() - t0:.1f}s "
          f"with trace generation; {card}")
    counts = {k: mod.launches for k, mod in kernel_counters().items()}
    need(not any(counts.values()), f"simulate: kernels launched {counts}")
    print(f"[simulate] kernel launches over the phase: {json.dumps(counts)}"
          f" (the simulator runs no kernel of its own); phase "
          f"{time.monotonic() - t_phase:.1f}s")


# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="build, check each kernel once and run the launcher; "
                         "no timing, no serving")
    ap.add_argument("--against", nargs="+", type=Path, default=[],
                    metavar="DIR",
                    help="other checkouts of the repo: time their IVF band "
                         "scan and fused probe beside this tree's, in "
                         "turns; runs the build and kernel phases only")
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

        others = {}
        for root in args.against:
            t0 = time.monotonic()
            others[root.name] = load_other_kernels(root.resolve())
            print(f"[build] kernels of {root}: "
                  f"{time.monotonic() - t0:.1f}s")

        phase = "kernels"
        records = {}
        checks = [functools.partial(check_ivf_scan, ivf, others),
                  functools.partial(check_fused_serve, ivf, others)]
        if not others:
            checks = [check_simsearch, check_flash, check_decode, *checks,
                      check_embedding_bag]
        for check in checks:
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

        if not others:
            phase = "launcher"
            launcher_phase()
        if not (others or args.quick):
            phase = "serve"
            serve_phase(records, ivf, build_s)
            phase = "serve recsys"
            serve_recsys(records)
            phase = "simulate"
            simulate_phase(card)
        torch.cuda.synchronize()
    except Exception as e:  # noqa: BLE001 — report the phase, then fail
        print(f"chip_smoke: phase {phase} FAILED: {e!r}", file=sys.stderr)
        raise
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "composite_ms", "composite")
    print(json.dumps({"kernels": [
        {**{k: rec.get(k) for k in keys},
         **{k: rec[k] for k in ("calls", "turns") if k in rec}}
        for rec in records.values()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
