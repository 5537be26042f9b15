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
   tier; GQA groups 16, 5 and 3, and the MoE models' serve shapes, G 1
   (H = Kv = 16) and G 5 (H 40, Kv 8) at head dim 128; Wide&Deep's deep
   and wide bags bit for bit at serve_p99 and serve_bulk, with edge
   cases; decode attention also against its split-KV plain version,
   lengths 0 to S), and time
   each beside its plain version, a library call or composite that
   computes the same function (used nowhere in the port) and the bound
   computed from the shapes. Every kernel and its library call or
   composite are timed in turns within the call (``turns_ms``: 9
   rounds, each a block of calls of each side, queued behind a spin
   kernel for the card's time and as launched): simsearch at B 32, 1
   and 8, attention at the serve shapes (decode at the serve run's own
   lengths, flash at B=1, S=1000 too), the IVF and fused probes, and the
   bag's four Wide&Deep calls (flash and decode also at the MoE serve
   shape, G 1);
4. launcher: ``python -m repro_torch.launch.serve`` as a user runs it,
   with no ``--device``: the card, 0 router errors, its kernels launched;
   then with ``--shards 4``: a simsearch launch a shard a router batch;
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
5a. serve sharded: the same engine and tier on a mesh of four shards
   (all on the card when it is the only one): the flat run (four
   simsearch launches a router batch, each over 1,048,576 rows) with two
   twins served in lockstep, the mesh with the plain kernels and one
   device with the kernels, every decision identical to both; the IVF
   run over a layout a shard (K = 2048, nprobe 8, C 32; four ivf_scan
   launches a router batch) with its plain twin and its agreement with
   the flat path; shard occupancy, launches and peak memory; the four
   quarter-scans timed in turns against one whole-tier simsearch launch
   (recorded, not claimed: what sharding costs on one card); and
   Wide&Deep's ``retrieval_sharded`` over 1,000,000 range-partitioned
   candidates, the same top-100 ids as one device's ``retrieval``;
6. operability: the same model and tier with the L1 front, volatile
   bypass, class TTLs, a rewriter, the promotion WAL and adaptive
   thresholds: 128 requests through the router, a snapshot with the
   last verdicts' promotions landing after it (the WAL's tail), a fresh
   policy on the card from the snapshot plus the tail (every tier column's
   ``state_hash`` equal to the live one's, the next 64 decisions
   identical), the IVF layout warm-restored from a second snapshot with
   the segmented index rebuilt by ``bulk_load`` (decisions identical to
   the cold-built index's, ``ivf_scan`` launched), then the launcher with
   ``--snapshot-dir --wal --l1-capacity --adaptive``, one
   ``--serve-stdio`` process (serve, drain, snapshot, stats, killed) and
   a restart that replays the WAL tail; snapshot bytes and wall, warm
   against cold IVF, WAL appends a second and the shadow sweep's wall
   printed;
6a. serve moe: full-width Qwen2-MoE-A2.7B (14.3 B parameters, bf16,
   seeded random weights) behind the same tier, flat: 128 requests, 24
   flash launches a prefill, 24 decode launches a step, one simsearch
   launch a router batch, decisions against the plain static top-1;
   layer 0's MoE in fp32 on seeded states (T 512 sort, T 8 and 32
   einsum, the model's router and one skewed to drop slots), card
   against CPU: expert ids and kept slots identical, outputs within
   1e-4 of max |y|; the model against plain attention with routing
   flips counted (the first flip of each sequence within 2^-6 of the
   k-th probability) and its logits under the kernel run's routing
   within 5e-2; a decode step beside its bound, profiled; the launcher
   with ``--arch qwen2-moe-a2.7b``; Llama-4-Scout at every published
   width, 4 of its 48 layers, under the same model check;
7. serve recsys: every recsys kind at full width with random weights
   through ``launch/workloads.build_workload`` (Wide&Deep: 40 fields x 4
   ids, embed 32, MLP 1024-512-256, a 4,001,792-row table; SASRec,
   MIND and BST at their published dims, 1,001,472-row item tables):
   serve_p99 (8 batches of 512), serve_bulk (1 of 262,144) and
   retrieval_cand (4 queries against 1,000,000 candidates, top-100);
   embedding_bag launches counted (2 a Wide&Deep serve batch, 1 a
   query, 0 for the other kinds), Wide&Deep's outputs bit-identical to
   the same batches through the plain bag; each kind at smoke size on
   the card against the CPU;
7a. train recsys: every kind's train_batch workload (65,536 rows, one
   AdamW step a call): a warm-up step, then 3 steps with the counts
   zeroed (2 bag launches a Wide&Deep step, its forward under
   autograd), loss and grad_norm finite, every parameter leaf changed;
   one Wide&Deep step again from the same state with the plain bag
   under autograd (loss bit-identical, gradients, grad_norm and params
   within stated tolerances); the bag's forward and ``index_add_``
   backward timed in turns at the step's shapes; Wide&Deep's ``train_loop.train`` at full width,
   preempted after a checkpoint and resumed, the resumed step's loss
   against the uninterrupted run's;
7b. train gnn: GraphSAGE (``graphsage-reddit``, 2 layers, d_hidden 128,
   mean, 41 classes) through ``build_gnn`` at every GNN shape at its
   published size (full_graph_sm 2,708 nodes x 1433 features;
   minibatch_lg a batch of 1024 at fanout 15-10 over a 232,965-node
   sampler graph; ogb_products 2,449,029 nodes, 61,859,140 edges;
   molecule 128 graphs): one step's loss, grad_norm and every gradient
   leaf card against CPU (ogb_products: layer 0's aggregation against
   an fp64 twin), then 3 AdamW steps each by CUDA events, no kernel
   launched, peak memory and the bytes the gathers and segment sums
   move against the HBM rate;
7c. train lm: full-width Qwen3-1.7B at S 4096, B 2, through
   ``build_lm``: step 1 against a plain-attention twin, 3 AdamW steps
   with 56 flash launches a step (the kernel under ``FlashAttention``,
   twice a layer under remat), tokens/s and the model-flop share;
   Qwen2-MoE-A2.7B at every width, 2 of its 24 layers, one step against
   its twin; the flash kernel under autograd at the train shape
   (gradients against the plain version, forward and forward+backward
   in turns beside SDPA); prefill_32k (B 1) and decode_32k (B 8 against
   a 30 GB cache at length 32,767) against plain twins, with flash at
   S 32,768 and decode attention at 32,768 positions in turns beside
   SDPA; ``python -m repro_torch.launch.train`` with ``--smoke --steps
   20`` and at full width for 5 steps;
8. simulate: the trace simulator, which launches none of the kernels
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
import dataclasses
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
RECSYS_ARCHS = ("wide-deep", "sasrec", "mind", "bst")   # full width
TRAIN_STEPS = 3             # timed train_batch steps a kind, after 1
TURN_ROUNDS = 9             # rounds of kernel vs library call, in turns
LAUNCHER_REQUESTS = 64
SHARDS = 4                  # the sharded serve runs' mesh
SHARD_CLUSTERS = 2048       # IVF clusters a shard: 8192 in all, as the
                            # one-device layout
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

    def inputs(B, S, dtype=torch.bfloat16, h=H, kv=Kv):
        def r(*shape):
            return torch.randn(shape, generator=g, device="cuda",
                               dtype=dtype)
        return r(B, S, h, D), r(B, S, kv, D), r(B, S, kv, D)

    err = 0.0
    # the serve shapes, long S, ragged tiles, and G = 1, 4 and 16 (h 8,
    # 32, 128); Qwen2-MoE's serve shape (G 1: H = Kv = 16) and
    # Llama-4-Scout's (G 5: H 40, Kv 8)
    cases = [(8, 40, H, Kv), (8, 64, H, Kv), (1, 1000, H, Kv),
             (2, 1, H, Kv), (2, 17, H, Kv), (2, 65, H, Kv), (2, 33, Kv, Kv),
             (2, 33, 4 * Kv, Kv), (2, 33, 16 * Kv, Kv), (8, 64, 16, 16),
             (8, 48, 40, 8)]
    for B, S, h, kv in cases:
        q, k, v = inputs(B, S, h=h, kv=kv)
        ref = causal_attention(q.float(), k.float(), v.float())
        for pair in (None, False, True):
            out = K.flash_attention(q, k, v, pair_tiles=pair)
            need(out.dtype == torch.bfloat16 and out.shape == q.shape,
                 f"flash B={B} S={S}: output {out.dtype} "
                 f"{tuple(out.shape)}")
            e = float((out.float() - ref).abs().max())
            need(math.isfinite(e) and e <= ATTN_TOL,
                 f"flash B={B} S={S} H={h} Kv={kv} pair_tiles {pair}: max "
                 f"abs err {e:.3g} > {ATTN_TOL}")
            err = max(err, e)
    q, k, v = inputs(2, 65, torch.float32)
    e32 = float((K.flash_attention(q, k, v)
                 - causal_attention(q, k, v)).abs().max())
    need(e32 <= F32_TOL, f"flash fp32: max abs err {e32:.3g} > {F32_TOL}")
    print(f"[kernels] flash_attention: bf16 max_abs_err {err:.3g} over "
          f"{len(cases)} shapes (S 1-1000, G 1/2/4/5/16; G 1 at B=8 S=64 "
          f"H=Kv=16, the MoE serve shape), q tiles paired, unpaired and "
          f"by default; fp32 {e32:.3g}")
    rec = {"name": "flash_attention", "route": "cuda",
           "source": "src/repro_torch/csrc/flash_attention.cu",
           "replaces": "src/repro/kernels/flash_attention/kernel.py:84",
           "max_abs_err": err}
    if quick:
        return rec

    def bound_of(B, S, h, kv):
        pairs = S * (S + 1) // 2              # causal (query, key) pairs
        return bound(2 * (2 * B * S * h * D + 2 * B * S * kv * D),
                     4 * B * h * D * pairs, "bfloat16")

    for B, S, h, kv in ((8, 64, H, Kv), (1, 1000, H, Kv), (8, 64, 16, 16)):
        q, k, v = inputs(B, S, h=h, kv=kv)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        fns = {"kernel": lambda i: K.flash_attention(q, k, v)}
        for name, pair in (("unpaired", False), ("paired", True)):
            fns[f"kernel {name}"] = functools.partial(
                lambda i, pair: K.flash_attention(q, k, v, pair_tiles=pair),
                pair=pair)
        fns["sdpa"] = lambda i: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)
        label = f"flash B={B} S={S}" + (f" G=1 H={h}" if h == kv else "")
        res = _turns(rec, label, fns, 50)
        b_ms, b_by = bound_of(B, S, h, kv)
        print(f"[kernels] {label}: kernel/SDPA "
              f"{res['kernel']['median'] / res['sdpa']['median']:.3f}, "
              f"bound {b_ms:.4f} ms ({b_by})")
        if (B, S, h, kv) == (8, 64, H, Kv):
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
    # Qwen2-MoE's serve shape: G 1 (H = Kv = 16), a cache a layer (24)
    Lm, Km = 24, 16
    km, vm = r(Lm, B, S, Km, D), r(Lm, B, S, Km, D)
    qm = r(B, Km, D)
    for lens in (edge, serve_lengths):
        out = K.decode_attention(qm, km[0], vm[0], lens)
        ref = decode_attention(qm.float()[:, None], km[0].float(),
                               vm[0].float(), lens)[:, 0]
        e = float((out.float() - ref).abs().max())
        need(out.shape == qm.shape and math.isfinite(e) and e <= ATTN_TOL,
             f"decode G=1 Kv={Km}: max abs err {e:.3g} > {ATTN_TOL}")
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
          f"edges {edge.tolist()}, G 2/16/5/3 and G 1 at Kv {Km} (the MoE "
          f"serve shape); fp32 {e32:.3g} (G 2/16/5); "
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
    mask = (torch.arange(S, device="cuda")[None, :]
            < serve_lengths[:, None])[:, None, None, :]
    qmt, kmt, vmt = qm[:, :, None, :], km.transpose(2, 3), vm.transpose(2, 3)
    label = f"decode B={B} S={S} G=1 Kv={Km} uniform {serve_len}"
    res = _turns(rec, label, {
        "kernel": lambda i: K.decode_attention(qm, km[i % Lm], vm[i % Lm],
                                               serve_lengths),
        "sdpa": lambda i: F.scaled_dot_product_attention(
            qmt, kmt[i % Lm], vmt[i % Lm], attn_mask=mask)}, 48)
    live = int(serve_lengths.sum())
    b_ms, b_by = bound(2 * (2 * B * Km * D + 2 * live * Km * D) + 4 * B,
                       4 * live * Km * D, "bfloat16")
    print(f"[kernels] {label}: kernel/SDPA "
          f"{res['kernel']['median'] / res['sdpa']['median']:.3f}, bound "
          f"{b_ms:.4f} ms ({b_by})")
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
    from repro_torch.device import batch_from_numpy
    from repro_torch.models import recsys
    b = batch_from_numpy(next(recsys_batches(cfg, B, seed)), "cuda")
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

def launcher_run(extra=()) -> tuple:
    """``python -m repro_torch.launch.serve --requests N *extra`` with
    no ``--device``: the card, the smoke config of ``--arch`` shaped for
    it (head dim 64) and the CUDA kernels. Every count is zeroed just
    before and read just after; the run must end with 0 router errors
    and every kernel of its path launched. Returns (router stats,
    launch counts)."""
    from repro_torch.launch import serve
    reset_counts()
    t0 = time.monotonic()
    stats = serve.main(["--requests", str(LAUNCHER_REQUESTS), *extra])
    counts = {n: m.launches for n, m in kernel_counters().items()}
    argv = " ".join(["--requests", str(LAUNCHER_REQUESTS), *extra])
    print(f"[launcher] python -m repro_torch.launch.serve {argv} (no "
          f"--device): {time.monotonic() - t0:.1f}s, errors "
          f"{stats['errors']}, kernel launches {json.dumps(counts)}")
    need(stats["errors"] == 0, f"launcher {' '.join(extra)}: router errors "
         f"{stats['errors']}: {stats.get('last_error')}")
    need(all(counts[k] > 0 for k in ("simsearch", "flash_attention",
                                     "decode_attention")),
         f"launcher: a kernel of its path never launched: {counts}")
    return stats, counts


def launcher_phase() -> None:
    """The launcher as a user runs it: the default arch, then on four
    shards (a simsearch launch a shard a router batch)."""
    launcher_run()
    stats, counts = launcher_run(["--shards", str(SHARDS)])
    print(f"[launcher] --shards {SHARDS}: shard occupancy "
          f"{stats['shard_occupancy']}, router batches {stats['batches']}")
    need(counts["simsearch"] == SHARDS * stats["batches"],
         f"launcher --shards: simsearch launches {counts['simsearch']} != "
         f"{SHARDS} x router batches {stats['batches']}")


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
    """Swap the simsearch, IVF and fused kernel wrappers for their plain
    versions (same signatures); the swapped-in functions count no
    launches."""
    from repro_torch.kernels.fused_serve import kernel as fk
    from repro_torch.kernels.fused_serve.ref import fused_kernel_ref
    from repro_torch.kernels.ivf_scan import kernel as ik
    from repro_torch.kernels.ivf_scan.ref import band_scan_ref
    from repro_torch.kernels.simsearch import kernel as sk
    from repro_torch.kernels.simsearch.ref import simsearch_ref
    saved = ik.ivf_scan, fk.fused_serve, sk.simsearch
    ik.ivf_scan, fk.fused_serve = band_scan_ref, fused_kernel_ref
    sk.simsearch = simsearch_ref
    try:
        yield
    finally:
        ik.ivf_scan, fk.fused_serve, sk.simsearch = saved


def lockstep_twin(pol, one_device=None, plain=True):
    """A twin of ``pol`` (same static tier, layout, embedder and lookup
    settings, its own dynamic tier and index) that serves every batch
    right after ``pol`` does, its backend replaying ``pol``'s answers:
    with the plain versions of the kernels (``plain``), on ``pol``'s
    mesh or on one device (``one_device``: the whole static tier of a
    sharded ``pol``, served by the flat lookups, with ``pol``'s kernels
    unless ``plain``). Both judge pools are drained
    after each batch, so promotions land at the same points in both. A
    twin's kernel launches are taken back out of the counts. Twins nest:
    each call wraps the serving entry the last one left. Returns (twin,
    list of (results, twin results) per batch)."""
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
    twin = KritesPolicy(pol.cfg, pol.static if one_device is None
                        else one_device, pol.static_answers,
                        pol.embed_fn, backend_fn=None,
                        judge_fn=OracleJudge(), d=EMB_DIM,
                        backend_batch_fn=replay,
                        static_texts=pol.static_texts,
                        index=pol.index if one_device is None else None,
                        dyn_index=dyn, fused=pol.fused,
                        mesh=pol.mesh if one_device is None else None,
                        device=pol.device)
    serve = pol.serve_batch

    def serve_batch(prompts, metas=None):
        out = serve(prompts, metas)
        pol.pool.drain(60.0)
        counts = {m: m.launches for m in kernel_counters().values()}
        with plain_kernels() if plain else contextlib.nullcontext():
            pairs.append((out, twin.serve_batch(prompts, metas)))
            twin.pool.drain(60.0)
        for m, n in counts.items():
            m.launches = n
        return out

    pol.backend_batch_fn = recorded
    pol.serve_batch = serve_batch
    return twin, pairs


def check_twin(name, pairs, tau, twin="plain twin's") -> None:
    """Every served decision equals the twin's (plain kernels, same
    layout, or one device); scores within SCORE_TOL."""
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
    print(f"[serve {name}] all {rows} decisions identical to the {twin} "
          f"({near} rows within {SCORE_TOL} of tau)")


def flat_agreement(name, pol, index_at, layout, build_s, reqs,
                   rows) -> None:
    """How often the IVF static top-1 (``index_at(nprobe)``, a layout
    described by ``layout``) is the exact flat top-1 over the whole
    static tier ``rows`` for the run's queries (recall@1), and the
    static-hit decision agreement, at the run's nprobe and at 4x that
    (measured after the run's counts were read)."""
    import torch
    from repro_torch.kernels.simsearch.ref import simsearch_ref
    V = torch.as_tensor(pol.embed_fn.batch([p for p, _ in reqs]),
                        device="cuda")
    fs, fi = simsearch_ref(V, rows, 1)
    tau = pol.cfg.tau_static
    print(f"[serve {name}] static tier IVF ({layout}) built in "
          f"{build_s:.2f}s")
    for nprobe in (IVF_NPROBE, 4 * IVF_NPROBE):
        vs, vi = index_at(nprobe).topk(V)
        print(f"[serve {name}] agreement with the flat path over the "
              f"run's {len(reqs)} queries at nprobe {nprobe}: static "
              f"top-1 id {float((fi == vi).float().mean()):.4f}, "
              f"static-hit decision "
              f"{float(((fs >= tau) == (vs >= tau)).float().mean()):.4f}")


def check_flat_run(name, service, reqs, results, counts, rs,
                   records) -> None:
    """A flat run: one simsearch launch a router batch, every served
    decision as the plain static top-1 on the card decides it; the
    launches of its three kernels go into ``records`` (by run)."""
    import numpy as np
    import torch
    from repro_torch.kernels.simsearch.ref import simsearch_ref

    # a router batch holds at most 32 rows: one simsearch launch each
    need(counts["simsearch"] == rs["batches"],
         f"{name}: simsearch launches {counts['simsearch']} != batches "
         f"{rs['batches']}")
    for k in ("simsearch", "flash_attention", "decode_attention"):
        records[k].setdefault("launches_by_run", {})[name] = counts[k]
        records[k]["launches"] = sum(records[k]["launches_by_run"]
                                     .values())
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
    need(not bad, f"{name}: served decisions disagree with the plain "
         f"static top-1 at rows {bad[:8]}")
    for i, r in enumerate(results):
        need(r.served_by != "static"
             or abs(r.similarity - ref_s[i]) <= SCORE_TOL,
             f"{name} row {i}: served {r.similarity} vs plain {ref_s[i]}")
    print(f"[serve {name}] decisions agree with the plain static top-1 "
          f"on all {len(results)} rows")


def serve_phase(records: dict, ivf, build_s: float):
    """The three serve runs; returns the full-width engine they share."""
    from repro_torch.configs import QWEN3_1_7B
    from repro_torch.index.ivf import IVFIndex
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
        check_flat_run("flat", service, reqs, results, counts, rs,
                       records)
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
            flat_agreement(
                name, service.policy,
                lambda n: IVFIndex(ivf, nprobe=n, n_candidates=IVF_C),
                f"K={ivf.codes.shape[0]}, cap={ivf.codes.shape[1]}",
                build_s, reqs, service.policy.static.emb)
        finally:
            twin.pool.stop()
            service.stop()
        del service, twin, pairs
    return engine


def check_model(engine) -> None:
    """The full-width model with the kernels against the same weights
    with plain attention: prefill logits and four greedy decode steps,
    the plain run fed the kernel run's tokens, so that every step
    compares the two on the same inputs (a greedy token can flip where
    the top two logits lie within the bf16 error; each such flip is
    printed with the plain run's gap)."""
    import torch
    from repro_torch.models import attention as plain
    from repro_torch.models import transformer as tr

    cfg, params = engine.cfg, engine.params
    toks = torch.stack([torch.from_numpy(engine.tok.encode(p, max_len=48))
                        for p in ("how do i fix my bike",
                                  "quick q: how do i sell my router")]
                       ).to("cuda", torch.int64)

    def run(feed=None):
        logits, cache = tr.prefill(cfg, params, toks, max_len=64)
        outs, fed = [logits], []
        for s in range(4):
            fed.append(feed[s] if feed else torch.argmax(logits, -1))
            logits, cache = tr.decode_step(cfg, params, cache, fed[-1])
            outs.append(logits)
        return torch.stack(outs), fed

    with_kernels, fed = run()
    saved = tr.attention, tr.decode_attention
    tr.attention = plain.causal_attention
    tr.decode_attention = lambda q, kc, vc, n: plain.decode_attention(
        q[:, None], kc, vc, n)[:, 0]
    try:
        with_plain, _ = run(fed)
    finally:
        tr.attention, tr.decode_attention = saved
    need(bool(with_kernels.isfinite().all()), "model logits not finite")
    scale = with_plain.abs().max()
    rel = float((with_kernels - with_plain).abs().max() / scale)
    differ = with_kernels.argmax(-1) != with_plain.argmax(-1)
    top2 = with_plain.topk(2, dim=-1).values
    gaps = [round(float((top2[s, b, 0] - top2[s, b, 1]) / scale), 5)
            for s, b in differ.nonzero().tolist()]
    print(f"[serve] model vs plain attention (the plain run fed the "
          f"kernel run's tokens): max rel logit err {rel:.3g}, greedy "
          f"token agreement {1 - float(differ.float().mean()):.3f} (the "
          f"plain run's top-2 gap, over max |logit|, where they differ: "
          f"{gaps})")
    need(rel <= LOGIT_REL_TOL, f"model logits rel err {rel:.3g} > "
         f"{LOGIT_REL_TOL}")


# ---------------------------------------------------------------------------
# phase 5a: serve sharded
# ---------------------------------------------------------------------------

def _occupancy(name, pol) -> None:
    st = pol.shard_stats()
    print(f"[serve {name}] shards {st['shards']}, dynamic-tier occupancy a "
          f"shard {st['shard_occupancy']} (of {pol.cfg.capacity // SHARDS} "
          f"slots each)")
    need(sum(st["shard_occupancy"]) == int(pol._valid_np.sum()),
         f"{name}: shard occupancy {st['shard_occupancy']} does not sum "
         f"to the {int(pol._valid_np.sum())} live entries")


def _sharded_turns(tier, mesh) -> None:
    """The four quarter-scans of a sharded lookup (four simsearch
    launches and the merge) against one whole-tier simsearch launch, in
    turns within the call, on the same query batches (B=32). Recorded,
    not claimed: what sharding costs on one card."""
    import torch
    from repro_torch.index import sharded as Sh
    from repro_torch.kernels.simsearch.ops import cosine_topk
    g = torch.Generator(device="cuda").manual_seed(5)
    sets = [_ivf_queries(g, tier.emb, 32) for _ in range(N_BATCH_SETS)]
    parts = Sh.shard_rows(tier.emb, mesh)
    fns = {"4 shards": lambda i: Sh.sharded_cosine_topk(
               sets[i % N_BATCH_SETS], parts, mesh, k=1),
           "one launch": lambda i: cosine_topk(sets[i % N_BATCH_SETS],
                                               tier.emb, k=1)}
    need(all(torch.equal(fns["4 shards"](i)[1], fns["one launch"](i)[1])
             for i in range(N_BATCH_SETS)),
         "sharded static top-1 ids differ from one launch's")
    for queued in (True, False):
        t = turns_ms(fns, calls=20, queued=queued)
        a, b = t["4 shards"], t["one launch"]
        print(f"[serve sharded] turns B=32 over N={tier.emb.shape[0]}: "
              f"{SHARDS} shards {a['median']:.4f} ms [{a['min']:.4f}, "
              f"{a['max']:.4f}] vs one simsearch launch {b['median']:.4f} "
              f"ms [{b['min']:.4f}, {b['max']:.4f}], ratio "
              f"{a['median'] / b['median']:.3f} ({TURN_ROUNDS} rounds x 20 "
              f"calls, {'card time, queued' if queued else 'as launched'});"
              f" ids identical on {N_BATCH_SETS} batches")


def _sharded_retrieval(mesh) -> None:
    """Wide&Deep retrieval at full width over a range-partitioned list
    of 1,000,000 candidates (250,000 of each shard's item rows):
    ``retrieval_sharded`` at four shards against ``retrieval`` on one
    device, the same top-100 ids."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch.workloads import build_workload
    from repro_torch.models import recsys as R
    cfg = get_arch(WD_ARCH)
    wl = build_workload(WD_ARCH, "retrieval_cand", device="cuda",
                        seed=WD_SEED)
    params, batch = wl.args
    rows = params["item_emb"].shape[0]
    per, n = rows // SHARDS, batch["cand_ids"].shape[0] // SHARDS
    g = torch.Generator(device="cuda").manual_seed(7)
    cand = torch.cat([s * per + 1 + torch.randperm(per - 1, generator=g,
                                                   device="cuda")[:n]
                      for s in range(SHARDS)]).to(torch.int32)
    rb = dict(batch, cand_ids=cand)
    R.retrieval_sharded(cfg, params, rb, mesh, k=100)        # warm-up
    R.retrieval(cfg, params, rb, k=100)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.monotonic()
    sv, si = R.retrieval_sharded(cfg, params, rb, mesh, k=100)
    torch.cuda.synchronize()
    t_sh = time.monotonic() - t0
    bags = kernel_counters()["embedding_bag"].launches
    t0 = time.monotonic()
    v, i = R.retrieval(cfg, params, rb, k=100)
    torch.cuda.synchronize()
    t_one = time.monotonic() - t0
    err = float((sv - v).abs().max())
    same = torch.equal(si, i)
    if not same:
        # a mismatch is allowed only where a neighbour's score (or the
        # unseen 101st, past the last place) lies within SCORE_TOL
        step = (v[:, 1:] - v[:, :-1]).abs()
        edge = torch.zeros_like(v[:, :1])
        gap = torch.minimum(torch.cat([step, edge], 1),
                            torch.cat([edge + math.inf, step], 1))
        need(bool((gap[si != i] <= SCORE_TOL).all()) and err <= SCORE_TOL,
             f"sharded retrieval ids differ beyond near-ties (score err "
             f"{err:.3g})")
    print(f"[serve sharded] retrieval wide-deep:retrieval_cand, "
          f"{cand.numel()} range-partitioned candidates over {SHARDS} "
          f"shards of the {rows}-row item table: top-100 ids "
          f"{'identical to' if same else 'equal up to near-ties with'} "
          f"one device's, max score diff {err:.3g}; wall {1e3 * t_sh:.3f} "
          f"ms sharded vs {1e3 * t_one:.3f} ms one device (host clock "
          f"after a sync); embedding_bag launches {bags}")


def serve_sharded_phase(engine, tier) -> None:
    """The serve path on a mesh of four shards (all on the card when it
    is the only one): the flat run (a simsearch launch a shard a router
    batch) with two twins in lockstep, the same mesh with the plain
    kernels and one device with the kernels; the per-shard IVF run
    (K = 2048 a shard) with its plain twin and its agreement with the
    flat path; the quarter-scans timed against one whole-tier scan; and
    Wide&Deep's sharded retrieval against one device's."""
    import torch
    from repro_torch.configs import QWEN3_1_7B
    from repro_torch.index import sharded as Sh
    from repro_torch.launch.mesh import make_shard_mesh
    from repro_torch.launch.serve import build_service

    t_phase = time.monotonic()
    mesh = make_shard_mesh(SHARDS)
    print(f"[serve sharded] {torch.cuda.device_count()} visible card(s): "
          f"{SHARDS} shards on {', '.join(str(d) for d in mesh.devices)}")
    common = dict(device="cuda", static_rows=STATIC_ROWS, max_len=512,
                  max_new_tokens=16, router_batch=32, engine_batch=8,
                  engine=engine, shards=SHARDS)
    path = ("flash_attention", "decode_attention")
    service = build_service(QWEN3_1_7B, **common)
    pol = service.policy
    twin, pairs = lockstep_twin(pol)
    one, one_pairs = lockstep_twin(pol, one_device=tier, plain=False)
    try:
        _, _, counts, rs = drive_run("sharded", service, ("simsearch",
                                                          *path))
        need(counts["simsearch"] == SHARDS * rs["batches"],
             f"sharded simsearch launches {counts['simsearch']} != "
             f"{SHARDS} x router batches {rs['batches']}")
        _occupancy("sharded", pol)
        check_twin("sharded", pairs, pol.cfg.tau_static)
        check_twin("sharded", one_pairs, pol.cfg.tau_static,
                   "single-device flat twin's (simsearch over the whole "
                   "tier)")
    finally:
        twin.pool.stop()
        one.pool.stop()
        service.stop()
    del service, pol, twin, one, pairs, one_pairs
    _sharded_turns(tier, mesh)

    torch.cuda.synchronize()
    t0 = time.monotonic()
    sivf = Sh.build_sharded_ivf(tier.emb, mesh, n_clusters=SHARD_CLUSTERS,
                                corpus_normalized=True)
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    service = build_service(QWEN3_1_7B, index="ivf", nprobe=IVF_NPROBE,
                            ivf=sivf, **common)
    pol = service.policy
    twin, pairs = lockstep_twin(pol)
    try:
        reqs, _, counts, rs = drive_run("sharded ivf", service,
                                        ("ivf_scan", *path))
        need(counts["ivf_scan"] == SHARDS * rs["batches"],
             f"sharded ivf_scan launches {counts['ivf_scan']} != "
             f"{SHARDS} x router batches {rs['batches']}")
        _occupancy("sharded ivf", pol)
        check_twin("sharded ivf", pairs, pol.cfg.tau_static)
        K, cap = sivf[0].codes.shape[:2]
        flat_agreement("sharded ivf", pol,
                       lambda n: Sh.ShardedIVFIndex(tier.emb, mesh,
                                                    nprobe=n, sivf=sivf),
                       f"{SHARDS} shards, K={K} and cap={cap} a shard",
                       build_s, reqs, tier.emb)
    finally:
        twin.pool.stop()
        service.stop()
    del service, pol, twin, pairs, sivf
    torch.cuda.empty_cache()
    _sharded_retrieval(mesh)
    print(f"[serve sharded] phase {time.monotonic() - t_phase:.1f}s")


# ---------------------------------------------------------------------------
# phase 5b: operability
# ---------------------------------------------------------------------------

OPS_DIR = ROOT / "build" / "chip_smoke_ops"
OPS_PROBE = 64              # decisions compared after each restore
OPS_L1 = 256
OPS_ADAPT = dict(window=32, adapt_every=16, min_segment=16)
OPS_LAUNCH_FLAGS = ("--l1-capacity", "64", "--volatile-bypass",
                    "--ttl-stable", "4096", "--rewrite", "--adaptive",
                    "--adapt-window", "32", "--adapt-every", "16")
OPS_STDIO_PREFIXES = ("so, ", "ok so ")
OPS_WAL_APPENDS = {1: 256, 64: 4096}   # fsync_every -> appends timed


def _ops_requests(n: int, seed: int):
    """Demo requests; every 4th carries a class of its own, so the judge
    rules its grey-zone pair a REWRITE (the demo judge deems every
    would-be reject rewritable)."""
    from repro_torch.launch.serve import demo_requests
    return [(p, {"cls": m["cls"] + 100 * (i % 4 == 3)})
            for i, (p, m) in enumerate(demo_requests(n, seed=seed))]


def _ops_policy(live, **kw):
    """A fresh policy over ``live``'s static tier, embedder, backend and
    options, each with state of its own; ``kw`` overrides the lookups."""
    from repro_torch.core.adaptive import AdaptiveController, AdaptiveParams
    from repro_torch.core.exact_tier import ExactTier
    from repro_torch.core.judge import template_rewriter
    from repro_torch.core.policy import KritesPolicy
    return KritesPolicy(
        live.cfg, live.static, live.static_answers, live.embed_fn,
        backend_fn=live.backend_fn, judge_fn=live._judge_fn, d=EMB_DIM,
        backend_batch_fn=live.backend_batch_fn,
        static_texts=live.static_texts, l1=ExactTier(capacity=OPS_L1),
        freshness=live.freshness, rewriter=template_rewriter,
        adaptive=AdaptiveController(live.cfg, d=EMB_DIM,
                                    params=AdaptiveParams(**OPS_ADAPT)),
        device=live.device, **kw)


def _dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def _dyn_hashes(pol) -> dict:
    import dataclasses
    from repro_torch.serving.persist import state_hash
    return {f.name: state_hash(getattr(pol.dyn, f.name))
            for f in dataclasses.fields(pol.dyn)}


def _probe(name, pol, reqs, answers=None):
    """Serve ``reqs`` through ``pol.serve_batch`` in batches of 8, the
    judge pool drained after each. With ``answers`` (a previous probe's
    backend calls) the backend replays them instead of generating.
    Returns (decisions, the backend calls made)."""
    import torch
    calls, decs = [], []
    backend = pol.backend_batch_fn

    def replay(prompts):
        want, out = answers.pop(0)
        need(want == list(prompts), f"{name}: its backend rows differ "
             "from the restored policy's")
        return out

    def record(prompts):
        out = backend(prompts)
        calls.append((list(prompts), list(out)))
        return out
    pol.backend_batch_fn = record if answers is None else replay
    try:
        for b0 in range(0, len(reqs), 8):
            chunk = reqs[b0:b0 + 8]
            out = pol.serve_batch([p for p, _ in chunk],
                                  [m for _, m in chunk])
            pol.pool.drain(60.0)
            decs += [(r.served_by, r.answer, r.static_origin, r.similarity)
                     for r in out]
        torch.cuda.synchronize()
    finally:
        pol.backend_batch_fn = backend
    return decs, calls


def _same_decisions(name, got, want) -> None:
    """served_by, answer and static_origin equal; scores within
    SCORE_TOL (the segmented index reranks in another summation order
    than the flat scan)."""
    bad = [i for i, (a, b) in enumerate(zip(got, want))
           if a[:3] != b[:3] or not (a[3] == b[3]
                                     or abs(a[3] - b[3]) <= SCORE_TOL)]
    need(len(got) == len(want) == OPS_PROBE and not bad,
         f"{name}: decisions differ at rows {bad[:8]}: "
         f"{[(got[i], want[i]) for i in bad[:2]]}")


def _wal_rates() -> str:
    """Appends a second through ``PromotionWAL`` on this machine's disk,
    at fsync every append and every 64, with a 64-d record."""
    import numpy as np
    from repro_torch.core.promo_wal import PromotionWAL, encode_record
    out = []
    v = np.random.default_rng(0).normal(size=EMB_DIM).astype(np.float32)
    for every, n in OPS_WAL_APPENDS.items():
        path = OPS_DIR / f"rate{every}.wal"
        rec = encode_record(v, 3, 17, ttl=4096, q_text="how do i fix my "
                            "bike", h_text="how do i fix my bike")
        with PromotionWAL(path, fsync_every=every) as wal:
            t0 = time.perf_counter()
            for _ in range(n):
                wal.append(rec)
            wal.sync()
            dt = time.perf_counter() - t0
        out.append(f"fsync every {every}: {n / dt:.0f} appends/s ({n} "
                   f"appends, {path.stat().st_size} bytes)")
    return "; ".join(out)


def _stdio_crash(flags: list, snap_dir: Path) -> dict:
    """One ``--serve-stdio`` process over ``snap_dir``: serve, drain,
    snapshot, stats, serve more, drain, then SIGKILL (no final
    snapshot). Returns the replies by id."""
    import os
    import queue
    import threading
    from repro_torch.launch.serve import DEMO_INTENTS
    ops = [{"op": "serve", "id": k, "cls": k,
            "prompt": OPS_STDIO_PREFIXES[0] + p}
           for k, p in enumerate(DEMO_INTENTS[:16])]
    ops += [{"op": "drain", "id": "d1"}, {"op": "snapshot", "id": "s"},
            {"op": "stats", "id": "st"}]
    ops += [{"op": "serve", "id": 100 + k, "cls": k,
             "prompt": OPS_STDIO_PREFIXES[1] + p}
            for k, p in enumerate(DEMO_INTENTS[:16])]
    ops.append({"op": "drain", "id": "d2"})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", *flags,
         "--serve-stdio"], cwd=ROOT, env=env, text=True,
        stdin=subprocess.PIPE, stdout=subprocess.PIPE)
    lines: "queue.Queue[str | None]" = queue.Queue()

    def pump():
        for line in proc.stdout:
            lines.put(line)
        lines.put(None)
    reader = threading.Thread(target=pump, daemon=True)
    reader.start()
    replies: dict = {}
    try:
        proc.stdin.write("".join(json.dumps(o) + "\n" for o in ops))
        proc.stdin.flush()
        deadline = time.monotonic() + 180
        while "d2" not in replies:
            line = lines.get(timeout=max(1.0, deadline - time.monotonic()))
            need(line is not None, f"stdio service exited early "
                 f"(rc {proc.poll()}) after {sorted(map(str, replies))}")
            if line.startswith("{"):
                msg = json.loads(line)
                replies["ready" if msg.get("ready") else msg.get("id")] \
                    = msg
    finally:
        proc.kill()             # the crash: no final snapshot
        proc.wait(60)
        reader.join(10)
    return replies


def operability_phase(engine, ivf, build_s: float) -> None:
    """The operability layer at full width behind the 4,194,304-row tier
    (every kernel count zeroed just before each run and read just
    after):

    1. a live service with the L1 front, volatile bypass, class TTLs, a
       rewriter, the promotion WAL and adaptive thresholds serves 128
       requests through the router; the second 64's approved verdicts
       are held and applied after a snapshot taken there, as a slow
       promotion path lands them (so they form the WAL's tail);
    2. a fresh policy restored from the snapshot plus the WAL tail has
       the live dynamic tier (``state_hash`` of every column) and makes
       the next 64 decisions as the live one does;
    3. the static IVF layout (the build phase's) rides a second snapshot
       and warm-restores, with the segmented dynamic index rebuilt by
       ``bulk_load``; its decisions equal the cold-built index's;
    4. the launcher with ``--snapshot-dir --wal --l1-capacity --adaptive``
       runs, a ``--serve-stdio`` process restores it, serves, snapshots
       and is killed, and a restart replays the WAL tail."""
    import shutil

    import torch
    from repro_torch.configs import QWEN3_1_7B
    from repro_torch.core.adaptive import AdaptiveParams
    from repro_torch.core.freshness import FreshnessPolicy
    from repro_torch.core.judge import APPROVE, REWRITE
    from repro_torch.core.promo_wal import PromotionWAL, replay_into
    from repro_torch.index.ivf import IVFIndex
    from repro_torch.index.segmented import SegmentedIndex
    from repro_torch.launch import serve
    from repro_torch.launch.serve import build_service, drive
    from repro_torch.serving import persist

    t_phase = time.monotonic()
    shutil.rmtree(OPS_DIR, ignore_errors=True)
    OPS_DIR.mkdir(parents=True)
    pols = []
    wal = PromotionWAL(OPS_DIR / "promo.wal", fsync_every=1)
    service = build_service(
        QWEN3_1_7B, engine=engine, device="cuda", static_rows=STATIC_ROWS,
        max_len=512, max_new_tokens=16, router_batch=32, engine_batch=8,
        l1_capacity=OPS_L1, rewrite=True, wal=wal,
        freshness=FreshnessPolicy(volatile_bypass=True, ttl_volatile=0,
                                  ttl_stable=4096, ttl_unknown=4096),
        adaptive=AdaptiveParams(**OPS_ADAPT))
    live = service.policy
    try:
        # 1. the live run; sweeps timed where maybe_adapt runs one
        sweeps = []
        adapt = live.adaptive.maybe_adapt

        def timed(*a):
            t0 = time.perf_counter()
            ran = adapt(*a)
            if ran:
                torch.cuda.synchronize()
                sweeps.append(time.perf_counter() - t0)
            return ran
        live.adaptive.maybe_adapt = timed
        reqs = _ops_requests(SERVE_REQUESTS, seed=3)
        half = SERVE_REQUESTS // 2
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.monotonic()
        drive(service, reqs[:half], n_clients=32)
        live.pool.drain(60.0)
        held, actions = [], dict(live.pool.actions)
        live.pool.actions[APPROVE] = live.pool.actions[REWRITE] = \
            held.append
        drive(service, reqs[half:], n_clients=32)
        live.pool.drain(60.0)
        live.pool.actions.update(actions)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts = {n: m.launches for n, m in kernel_counters().items()}
        rs, ps = service.router.stats(), live.stats()
        print(f"[operability] live: {SERVE_REQUESTS} requests in "
              f"{wall:.2f}s: l1 {ps['l1_hit_rate']:.3f} static "
              f"{ps['static_hit_rate']:.3f} dynamic "
              f"{ps['dynamic_hit_rate']:.3f} rewritten "
              f"{ps['rewritten_hit_rate']:.3f} backend "
              f"{ps['backend_rate']:.3f} (volatile bypass "
              f"{ps['l1_bypass_volatile']}); judged {ps['judged']} approved "
              f"{ps['approved']} rewritten {ps['rewritten']}; adaptive "
              f"sweeps {ps['adaptive_adaptations']} moves "
              f"{ps['adaptive_moves']}; errors {rs['errors']}; kernel "
              f"launches {json.dumps(counts)}")
        need(rs["errors"] == 0, f"operability: router errors "
             f"{rs['errors']}: {rs.get('last_error')}")
        need(all(counts[k] > 0 for k in ("simsearch", "flash_attention",
                                         "decode_attention")),
             f"operability: a kernel of the live path never launched: "
             f"{counts}")
        need(ps["l1_hits"] > 0 and ps["l1_bypass_volatile"] > 0
             and ps["rewritten"] > 0 and ps["approved"] > 0
             and ps["adaptive_adaptations"] > 0,
             f"operability: a path went unexercised: {ps}")
        need(len(held) > 0, "operability: no verdict of the second half "
             "was held for the WAL tail")

        # the snapshot, then the held promotions land (the WAL's tail);
        # their verdicts reached the adaptive window before it, since
        # the WAL does not journal the window (test_torch_persist.py's
        # test_adaptive_evidence_after_the_snapshot_is_not_restored
        # holds the other order against the reference)
        t0 = time.monotonic()
        snap_path = persist.save_snapshot(OPS_DIR / "snap", live,
                                          include_static=False)
        save_s = time.monotonic() - t0
        cursor = wal.seq
        for payload in held:
            live._promote(payload)
        wal.sync()
        tail = wal.seq - cursor

        # 2. snapshot + WAL tail -> a fresh policy on the card
        rec = _ops_policy(live)
        pols.append(rec)
        t0 = time.monotonic()
        snap = persist.load_snapshot(OPS_DIR / "snap")
        load_s = time.monotonic() - t0
        t0 = time.monotonic()
        rep = persist.restore_policy(rec, snap)
        restore_s = time.monotonic() - t0
        t0 = time.monotonic()
        rr = replay_into(rec, OPS_DIR / "promo.wal",
                         skip=snap.extra["wal_seq"])
        replay_s = time.monotonic() - t0
        need(rep["index"] == "none" and rr["replayed"] == tail > 0
             and rr["skipped"] == cursor,
             f"operability: restore {rep}, replay {rr}, tail {tail}")
        hl, hr = _dyn_hashes(live), _dyn_hashes(rec)
        need(hl == hr, f"operability: restored tier differs: "
             f"{[f for f in hl if hl[f] != hr[f]]}")
        for f in ("_valid_np", "_last_used_np", "_static_origin_np",
                  "_written_at_np", "_expires_np", "_rewritten_np"):
            need((getattr(live, f) == getattr(rec, f)).all(),
                 f"operability: mirror {f} differs after restore")
        need(live.dyn_answers == rec.dyn_answers and live.t == rec.t,
             "operability: answers or clock differ after restore")
        print(f"[operability] snapshot (dynamic tier, mirrors, L1, "
              f"adaptive; static tier not included): save {save_s:.3f}s, "
              f"{_dir_bytes(snap_path)} bytes; load {load_s:.3f}s, restore "
              f"{restore_s:.3f}s (tier columns and mirrors; no static "
              f"tier to hash), WAL tail "
              f"replay {rr['replayed']} promotions in {replay_s:.3f}s "
              f"(skipped {rr['skipped']}); state_hash of all "
              f"{len(hl)} tier columns equal to the live policy's "
              f"({rep['dyn_live']} live entries)")

        probe = _ops_requests(OPS_PROBE, seed=4)
        reset_counts()
        got, calls = _probe("restored", rec, probe)
        counts = {n: m.launches for n, m in kernel_counters().items()}
        want, _ = _probe("live", live, probe, answers=list(calls))
        _same_decisions("restored vs live", got, want)
        need(all(counts[k] > 0 for k in ("simsearch", "flash_attention",
                                         "decode_attention")),
             f"operability: a kernel of the restored path never "
             f"launched: {counts}")
        print(f"[operability] restored policy: the next {OPS_PROBE} "
              f"decisions identical to the live policy's; kernel "
              f"launches {json.dumps(counts)}")

        # 3. the IVF layout through a snapshot: warm vs cold
        cold = _ops_policy(live, index=IVFIndex(ivf, nprobe=IVF_NPROBE,
                                                n_candidates=IVF_C))
        pols.append(cold)
        persist.restore_policy(cold, snap, rebuild="never")
        t0 = time.monotonic()
        ivf_path = persist.save_snapshot(OPS_DIR / "snap_ivf", cold,
                                         include_static=False)
        ivf_save_s = time.monotonic() - t0
        warm = _ops_policy(live, dyn_index=SegmentedIndex(
            DYN_CAPACITY, EMB_DIM, tail_rows=SEG_ROWS, nprobe=None,
            n_candidates=DYN_CAPACITY, tail_candidates=SEG_ROWS,
            device="cuda"))
        pols.append(warm)
        t0 = time.monotonic()
        snap_ivf = persist.load_snapshot(OPS_DIR / "snap_ivf")
        ivf_load_s = time.monotonic() - t0
        t0 = time.monotonic()
        rep = persist.restore_policy(warm, snap_ivf)
        torch.cuda.synchronize()
        warm_s = time.monotonic() - t0
        need(rep["index"] == "warm" and warm.index.ivf.corpus
             is warm.static.emb, f"operability: IVF restore {rep['index']}")
        st = warm.dyn_index_stats()
        need(st["live"] == rep["dyn_live"] and st["segments"] == 1,
             f"operability: bulk_load gave {st}")
        reset_counts()
        got, calls = _probe("warm", warm, probe)
        counts = {n: m.launches for n, m in kernel_counters().items()}
        want, _ = _probe("cold", cold, probe, answers=list(calls))
        _same_decisions("warm vs cold IVF", got, want)
        # one static lookup a batch that has rows past the L1 front, and
        # one launch a segment scan (serving and promotion dedup)
        scans = warm.dyn_index_stats()["scans"]
        need(scans > 0 and 0 < counts["ivf_scan"] - scans <= OPS_PROBE // 8,
             f"operability: ivf_scan launches {counts['ivf_scan']}, "
             f"segment scans {scans}, batches {OPS_PROBE // 8}")
        print(f"[operability] IVF snapshot: save {ivf_save_s:.3f}s, "
              f"{_dir_bytes(ivf_path)} bytes; load {ivf_load_s:.3f}s; warm "
              f"restore (layout to the card, static-tier hash, bulk_load "
              f"of {st['live']} entries) {warm_s:.3f}s vs cold build_ivf "
              f"{build_s:.3f}s over the {STATIC_ROWS}-row tier; the next "
              f"{OPS_PROBE} decisions identical to the cold-built "
              f"index's; kernel launches {json.dumps(counts)}")
        print(f"[operability] adaptive shadow grid (window "
              f"{OPS_ADAPT['window']}): {len(sweeps)} sweeps in the live "
              f"run, wall per maybe_adapt "
              + (f"{sum(sweeps) / len(sweeps):.4f}s (min {min(sweeps):.4f}"
                 f", max {max(sweeps):.4f})" if sweeps else "n/a"))
        print(f"[operability] WAL appends on this machine: {_wal_rates()}")
    finally:
        for pol in pols:
            pol.pool.stop()
        service.stop()
        wal.close()

    # 4. the launcher: run, stdio service killed after its snapshot,
    # restart replaying the WAL tail
    d = OPS_DIR / "launcher"
    flags = ["--snapshot-dir", str(d), *OPS_LAUNCH_FLAGS]
    reset_counts()
    t0 = time.monotonic()
    s1 = serve.main([*flags, "--requests", str(LAUNCHER_REQUESTS)])
    counts = {n: m.launches for n, m in kernel_counters().items()}
    need(s1["errors"] == 0 and persist.latest_snapshot(d) == 0,
         f"operability: launcher run {s1.get('errors')} errors")
    replies = _stdio_crash(flags, d)
    need(replies["s"]["ok"] and replies["st"]["ok"]
         and replies["d2"]["ok"] and all(replies[k]["ok"]
                                         for k in range(16)),
         f"operability: stdio replies {replies}")
    s2 = serve.main([*flags, "--requests", "16"])
    print(f"[operability] launcher {' '.join(flags)}: run 1 "
          f"{LAUNCHER_REQUESTS} requests, errors {s1['errors']}, kernel "
          f"launches {json.dumps(counts)}; --serve-stdio: ready at t "
          f"{replies['ready']['t']}, serve/drain/snapshot "
          f"({Path(replies['s']['snapshot']).name}, wal_seq "
          f"{replies['s']['wal_seq']})/stats ({replies['st']['stats']['requests']}"
          f" requests)/serve/drain, killed; restart: restored step "
          f"{s2.get('restored_step')} at t {s2.get('restored_t')}, WAL "
          f"replay {s2.get('wal_replayed')} promotions (skipped "
          f"{s2.get('wal_skipped')}), errors {s2['errors']}")
    need(s2.get("restored_step") == 1 and s2.get("wal_replayed", 0) > 0
         and s2["errors"] == 0, f"operability: the restart did not "
         f"replay: {s2}")
    shutil.rmtree(OPS_DIR, ignore_errors=True)
    print(f"[operability] phase {time.monotonic() - t_phase:.1f}s")


# ---------------------------------------------------------------------------
# phase 6a: serve moe
# ---------------------------------------------------------------------------

MOE_LAYER_RUNS = (("sort", 512), ("einsum", 8), ("einsum", 32))
MOE_LAYER_TOL = 1e-4        # fp32 MoE layer, card vs CPU, of max |y|
FLIP_MARGIN = 2.0 ** -6     # a routing flip past this margin is fatal
MOE_CHECK_PROMPTS = 8       # sequences of the model checks, 48 positions
SCOUT_LAYERS = 4            # Llama-4-Scout's 48 layers, cut to fit a card


def moe_layer_check(cfg, params) -> None:
    """Layer 0's MoE weights upcast to fp32, on seeded hidden states at
    the serve path's token counts (a prefill of 8 x 64: T 512 through
    the sort dispatch; decode steps of 8 and 32 rows through the einsum
    dispatch), on the card with TF32 off and on the CPU: expert ids and
    kept slots identical, outputs within MOE_LAYER_TOL of their max |y|.
    Each runs twice: with the model's router, and with a router that
    favours expert 0 on states with a common offset, so that both
    dispatches drop slots. This holds the CUDA dispatch (stable sort,
    searchsorted, gathers) against its CPU path, which the tests hold
    against JAX."""
    import torch
    from repro_torch.models import moe
    from repro_torch.models import transformer as tr

    m = cfg.moe
    w_gpu = {n: params["layers"][n][0].float() for n in tr._MOE_WEIGHTS
             if n in params["layers"]}
    skew_gpu = dict(w_gpu, router=w_gpu["router"].clone())
    skew_gpu["router"][:, 0] += 8.0 / cfg.d_model
    g = torch.Generator().manual_seed(11)
    dropped = 0
    for path, T in MOE_LAYER_RUNS:
        fn = moe._moe_ffn_sort if path == "sort" else moe._moe_ffn_einsum
        x = torch.randn(T, cfg.d_model, generator=g)
        for router, w, xs in (("model's", w_gpu, x),
                              ("skewed", skew_gpu, x + 1.0)):
            w_cpu = {n: t.cpu() for n, t in w.items()}
            t0 = time.monotonic()
            yc, _, ic, kc = fn(xs, w_cpu, m)
            cpu_s = time.monotonic() - t0
            yg, _, ig, kg = fn(xs.cuda(), w, m)
            torch.cuda.synchronize()
            probs = moe.router_topk(xs, w_cpu["router"], m.top_k)[2]
            srt = probs.sort(-1, descending=True).values
            gap = float(((srt[:, m.top_k - 1] - srt[:, m.top_k])
                         / srt[:, m.top_k - 1]).min())
            err = float((yg.cpu() - yc).abs().max() / yc.abs().max())
            n_drop = int((~kc).sum())
            dropped += n_drop
            C = (moe.sort_groups(T, m)[1] if path == "sort" else
                 moe.capacity(T, m.top_k, m.n_experts, m.capacity_factor))
            print(f"[serve moe] fp32 layer 0, {path} dispatch, T {T} (C "
                  f"{C}), {router} router: expert ids identical "
                  f"{torch.equal(ig.cpu(), ic)}, kept slots identical "
                  f"{torch.equal(kg.cpu(), kc)}, dropped {n_drop} of "
                  f"{kc.numel()} slots, max |y| err {err:.3g} of max |y|, "
                  f"smallest k-th margin {gap:.3g}; CPU {cpu_s:.2f}s")
            need(torch.equal(ig.cpu(), ic), f"moe layer {path} T {T} "
                 f"{router}: expert ids differ, card against CPU")
            need(torch.equal(kg.cpu(), kc), f"moe layer {path} T {T} "
                 f"{router}: kept slots differ, card against CPU")
            need(err <= MOE_LAYER_TOL, f"moe layer {path} T {T} {router}: "
                 f"err {err:.3g} > {MOE_LAYER_TOL}")
    need(dropped > 0, "moe layer check: no slot was dropped")


@contextlib.contextmanager
def recorded_routing(rec: list, force=None):
    """Record (expert ids, probs) of every ``router_topk`` call on the
    host, in call order. With ``force`` (a list of expert ids a call),
    each call routes to the given ids instead, weighted by its own
    probabilities at them, and records its own choice."""
    from repro_torch.models import moe
    saved = moe.router_topk

    def router_topk(x, w, k):
        idx, weights, probs = saved(x, w, k)
        rec.append((idx.cpu(), probs.cpu()))
        if force is not None:
            idx = force[len(rec) - 1].to(idx.device)
            weights = probs.gather(1, idx.long())
            weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)
        return idx, weights, probs
    moe.router_topk = router_topk
    try:
        yield
    finally:
        moe.router_topk = saved


def _flips(ref, other, S, n_layers, k):
    """Routing flips of ``other`` against ``ref`` (lists of (ids, probs)
    a router call: a prefill's n_layers calls over B x S tokens, then
    decode calls over B). A token flips when its experts (or their
    order) differ; its margin is, in ``other``, the k-th minus the
    (k+1)-th probability over the k-th (for an order swap, the smallest
    such gap among the top k). Returns (margins of all flips, margins of
    the flips where a sequence first diverged, flipped sequences)."""
    import torch
    every, roots, first = [], [], {}
    for c, ((ir, _), (io, po)) in enumerate(zip(ref, other)):
        seq = (torch.arange(len(ir)) // S if c < n_layers
               else torch.arange(len(ir)))
        for t in (ir != io).any(-1).nonzero()[:, 0].tolist():
            p = po[t].sort(descending=True).values
            if sorted(ir[t].tolist()) != sorted(io[t].tolist()):
                margin = float((p[k - 1] - p[k]) / p[k - 1])
            else:
                margin = min(float((p[j] - p[j + 1]) / p[j])
                             for j in range(k - 1))
            every.append(margin)
            if first.setdefault(int(seq[t]), c) == c:
                roots.append(margin)
    return every, roots, set(first)


def check_moe_model(label, cfg, params, tok) -> None:
    """The MoE model with the kernels against the same weights with plain
    attention: a prefill of MOE_CHECK_PROMPTS demo prompts (48
    positions) and 4 decode steps; the plain runs are fed the kernel
    run's greedy tokens. Every layer's expert choices are recorded.

    The free plain run routes by its own probabilities. Its flips are
    counted; those where a sequence first diverges, where the two runs'
    hidden states differ only by the attention numerics, are held to
    FLIP_MARGIN (fatal past it); later flips in that sequence follow
    from the divergence. The sequences with no flip are compared (at
    full width there may be none: a bf16 routing choice can flip at an
    ulp, and a sequence makes 48 x 24 of them). The forced plain run
    routes every token to the kernel run's experts (weighted by its own
    probabilities at them) and records what it would have chosen: its
    flips are counted, and all sequences' logits compared."""
    import torch
    from repro_torch.launch.serve import demo_requests
    from repro_torch.models import attention as plain
    from repro_torch.models import moe
    from repro_torch.models import transformer as tr

    S, k = 48, cfg.moe.top_k
    toks = torch.stack([torch.from_numpy(tok.encode(p, max_len=S))
                        for p, _ in demo_requests(MOE_CHECK_PROMPTS)]
                       ).to("cuda", torch.int64)
    B, T = toks.shape[0], toks.numel()
    g, _ = moe.sort_groups(T, cfg.moe)
    # capacity groups inside a sequence: a flip cannot move another
    # sequence's drops
    need(S % (T // g) == 0, f"{label}: groups of {T // g} straddle "
         f"sequences of {S}")

    def run(feed=None, force=None):
        rec, outs, fed = [], [], []
        with recorded_routing(rec, force):
            logits, cache = tr.prefill(cfg, params, toks, max_len=64)
            outs.append(logits)
            for s in range(4):
                fed.append(feed[s] if feed else torch.argmax(logits, -1))
                logits, cache = tr.decode_step(cfg, params, cache, fed[-1])
                outs.append(logits)
        return torch.stack(outs), fed, rec

    with_kernels, fed, rk = run()
    saved = tr.attention, tr.decode_attention
    tr.attention = plain.causal_attention
    tr.decode_attention = lambda q, kc, vc, n: plain.decode_attention(
        q[:, None], kc, vc, n)[:, 0]
    try:
        free, _, rp = run(fed)
        forced, _, rf = run(fed, [ids for ids, _ in rk])
    finally:
        tr.attention, tr.decode_attention = saved
    need(bool(with_kernels.isfinite().all()), f"{label}: logits not finite")
    need(len(rk) == len(rp) == len(rf) == 5 * cfg.n_layers,
         f"{label}: {len(rk)}, {len(rp)}, {len(rf)} router calls")

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    every, roots, seqs = _flips(rk, rp, S, cfg.n_layers, k)
    clean = [b for b in range(B) if b not in seqs]
    rel_clean = rel(with_kernels[:, clean], free[:, clean]) if clean \
        else math.nan
    print(f"[serve moe] {label} vs plain attention, free routing: "
          f"{len(every)} flips over {len(rk)} router calls, {len(roots)} "
          f"where a sequence first diverged (largest margin "
          f"{max(roots, default=0.0):.3g}, limit {FLIP_MARGIN:.3g}); "
          f"{len(clean)} of {B} sequences without a flip, max rel logit "
          f"err {rel_clean:.3g} over them")
    every_f, _, seqs_f = _flips(rk, rf, S, cfg.n_layers, k)
    every_f.sort()
    rel_forced = rel(with_kernels, forced)
    agree = float((with_kernels.argmax(-1) == forced.argmax(-1)).float()
                  .mean())
    print(f"[serve moe] {label} vs plain attention, forced routing: "
          f"{len(every_f)} tokens would have flipped, in {len(seqs_f)} "
          f"sequences (margins: largest {max(every_f, default=0.0):.3g}, "
          f"median {every_f[len(every_f) // 2] if every_f else 0.0:.3g}); "
          f"max rel logit err {rel_forced:.3g} over all {B} sequences, "
          f"greedy token agreement {agree:.3f}")
    worst = max(roots, default=0.0)
    need(worst <= FLIP_MARGIN, f"{label}: a first routing flip with "
         f"margin {worst:.3g} > {FLIP_MARGIN:.3g}")
    need(not clean or rel_clean <= LOGIT_REL_TOL, f"{label}: logits rel "
         f"err {rel_clean:.3g} > {LOGIT_REL_TOL} over the unflipped "
         f"sequences")
    need(rel_forced <= LOGIT_REL_TOL, f"{label}: logits rel err "
         f"{rel_forced:.3g} > {LOGIT_REL_TOL} under forced routing")


def moe_decode_step(cfg, params, tok, engine_step_s: float) -> None:
    """A decode step of 8 rows at the serve lengths, by CUDA events,
    beside the engine's wall a step and the bound: every weight the step
    reads (the einsum decode runs all experts at C rows), the live KV
    cache and the logits, over HBM bandwidth; the operations over the
    bf16 peak."""
    import torch
    from repro_torch.launch.serve import demo_requests
    from repro_torch.models import moe
    from repro_torch.models import transformer as tr

    m, B = cfg.moe, 8
    prompts = [p for p, _ in demo_requests(B)]
    in_len = max(8, max(len(p.encode()) + 2 for p in prompts))
    toks = torch.stack([torch.from_numpy(tok.encode(p, max_len=in_len))
                        for p in prompts]).to("cuda", torch.int64)
    logits, cache = tr.prefill(cfg, params, toks, max_len=512)
    nxt = torch.argmax(logits, -1)
    ms = cuda_ms(lambda i: tr.decode_step(cfg, params, cache, nxt), 10)
    prof_decode = _profile_steps(
        lambda: [tr.decode_step(cfg, params, cache, nxt) for _ in range(5)],
        5)
    prof_prefill = _profile_steps(
        lambda: tr.prefill(cfg, params, toks, max_len=512), 1)
    d, L, V = cfg.d_model, cfg.n_layers, cfg.vocab_size
    H, Kv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    C = moe.capacity(B, m.top_k, m.n_experts, m.capacity_factor)
    Fs = m.n_shared_experts * m.d_ff_expert
    nbytes = {n: t.numel() * t.element_size()
              for n, t in params["layers"].items()}
    routed = sum(nbytes[n] for n in ("wg", "wu", "wd"))
    shared = sum(nbytes.get(n, 0) for n in ("shared_wg", "shared_wu",
                                            "shared_wd"))
    attn = sum(nbytes[n] for n in ("wq", "wk", "wv", "wo"))
    unembed = tr._unembed_weight(cfg, params)
    unembed = unembed.numel() * unembed.element_size()
    kv = 2 * L * B * (in_len + 1) * Kv * D * 2
    total = sum(nbytes.values()) + unembed + kv + B * d * 2 + B * V * 4
    ops = L * (2 * B * d * (H + 2 * Kv) * D + 2 * B * H * D * d
               + 4 * B * (in_len + 1) * H * D + 2 * B * d * m.n_experts
               + 6 * m.n_experts * C * d * m.d_ff_expert
               + 6 * B * d * Fs) + 2 * B * d * V
    b_ms, b_by = bound(total, ops, "bfloat16")
    print(f"[serve moe] decode step, B {B} at length {in_len}: "
          f"{ms:.3f} ms (CUDA events, 10 steps), engine wall a step "
          f"{1e3 * engine_step_s:.3f} ms; bound {b_ms:.3f} ms ({b_by}: "
          f"{total / 1e9:.2f} GB read: routed experts {routed / 1e9:.2f} "
          f"(all {m.n_experts} at C {C}), shared {shared / 1e9:.2f}, "
          f"attention {attn / 1e9:.2f}, unembedding {unembed / 1e9:.2f}, "
          f"KV {kv / 1e9:.3f}); roofline share {b_ms / ms:.3f}")
    print(f"[serve moe] profiled decode step: {prof_decode}")
    print(f"[serve moe] profiled prefill of {B} x {in_len}: {prof_prefill}")


def serve_moe_phase(records: dict) -> None:
    """MoE serving on the card:

    1. full-width Qwen2-MoE-A2.7B (bf16, seeded random weights) behind
       the 4,194,304-row static tier, flat path: 128 requests from 32
       clients, one simsearch launch a router batch, 24 flash launches a
       prefill and 24 decode launches a step, decisions against the
       plain static top-1;
    2. its layer 0 in fp32, card against CPU (``moe_layer_check``);
    3. the model with kernels against plain attention, routing flips
       counted (``check_moe_model``);
    4. a decode step beside its bound (``moe_decode_step``);
    5. the launcher with ``--arch qwen2-moe-a2.7b`` (smoke config);
    6. Llama-4-Scout at every published width, cut to SCOUT_LAYERS of
       its 48 layers, under the check of 3 (top-1, GQA group 5)."""
    import gc

    import torch
    from repro_torch.configs import LLAMA4_SCOUT_17B_A16E, QWEN2_MOE_A2_7B
    from repro_torch.launch.serve import build_service
    from repro_torch.models import transformer as tr

    t_phase = time.monotonic()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = QWEN2_MOE_A2_7B
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    service = build_service(cfg, device="cuda", static_rows=STATIC_ROWS,
                            max_len=512, max_new_tokens=16, router_batch=32,
                            engine_batch=8)
    torch.cuda.synchronize()
    engine = service.engine
    try:
        n_params = sum(t.numel() for t in engine.params["layers"].values()) \
            + sum(t.numel() for n, t in engine.params.items()
                  if n != "layers")
        print(f"[serve moe] built in {time.monotonic() - t0:.1f}s: "
              f"{cfg.name} {cfg.n_layers}L d_model {cfg.d_model} "
              f"{cfg.n_heads}H/{cfg.n_kv_heads}KV head dim {cfg.head_dim}, "
              f"{cfg.moe.n_experts} experts of {cfg.moe.d_ff_expert} top-"
              f"{cfg.moe.top_k} + {cfg.moe.n_shared_experts} shared, "
              f"{cfg.dtype}, {n_params:,} params; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        need(n_params == cfg.param_count(), f"{n_params} params, config "
             f"{cfg.param_count()}")
        reqs, results, counts, rs = drive_run(
            "moe", service,
            ("simsearch", "flash_attention", "decode_attention"))
        check_flat_run("moe", service, reqs, results, counts, rs, records)
        es = engine.stats
        step_s = es.wall_decode_s / max(1, es.decode_steps)
        prefill_s = es.wall_prefill_s / max(1, es.batches)
        print(f"[serve moe] engine: prefill {prefill_s:.3f}s a batch, "
              f"decode {1e3 * step_s:.3f} ms a step")
    finally:
        service.stop()
    del service
    moe_layer_check(cfg, engine.params)
    check_moe_model(cfg.name, cfg, engine.params, engine.tok)
    moe_decode_step(cfg, engine.params, engine.tok, step_s)
    tok = engine.tok
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    launcher_run(["--arch", cfg.name])

    full = LLAMA4_SCOUT_17B_A16E
    cfg = dataclasses.replace(full, n_layers=SCOUT_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    params = tr.init_params(cfg, torch.Generator(device="cuda")
                            .manual_seed(0), "cuda")
    torch.cuda.synchronize()
    print(f"[serve moe] reduced: n_layers {full.n_layers} -> "
          f"{SCOUT_LAYERS} ({full.name}: every width as published, "
          f"d_model {cfg.d_model}, {cfg.n_heads}H/{cfg.n_kv_heads}KV, "
          f"{cfg.moe.n_experts} experts of {cfg.moe.d_ff_expert} top-"
          f"{cfg.moe.top_k} + {cfg.moe.n_shared_experts} shared, vocab "
          f"{cfg.vocab_size}; {cfg.param_count():,} params, "
          f"{cfg.param_count() * 2 / 1e9:.1f} GB bf16, built in "
          f"{time.monotonic() - t0:.1f}s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)")
    check_moe_model(f"{full.name} ({SCOUT_LAYERS} of {full.n_layers} "
                    f"layers)", cfg, params, tok)
    del params
    torch.cuda.empty_cache()
    print(f"[serve moe] phase {time.monotonic() - t_phase:.1f}s")


class _PlainBagFunction:
    """Stands in for ``ops.EmbeddingBag``: the plain version, which
    autograd differentiates directly (no kernel, no
    ``embedding_bag_backward``)."""

    @staticmethod
    def apply(table, ids, weights, groups):
        from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
        return embedding_bag_ref(table, ids, weights, groups)


@contextlib.contextmanager
def plain_bag():
    """Swap the embedding-bag kernel wrapper for its plain version (same
    signature) and the training path's ``EmbeddingBag`` Function for the
    plain version under autograd; the swapped-in functions count no
    launches."""
    from repro_torch.kernels.embedding_bag import kernel as bk
    from repro_torch.kernels.embedding_bag import ops
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    saved = bk.embedding_bag, ops.EmbeddingBag
    bk.embedding_bag, ops.EmbeddingBag = embedding_bag_ref, _PlainBagFunction
    try:
        yield
    finally:
        bk.embedding_bag, ops.EmbeddingBag = saved


def _check_outputs(name, got, rows, slate, n_items) -> None:
    """Serve scores (rows, slate), or retrieval (scores, ids) (1, 100):
    finite, of the expected shape; ids in 1..n_items, scores in
    descending order."""
    import torch
    if isinstance(got, tuple):
        v, i = got
        need(v.shape == i.shape == (1, 100) and i.dtype == torch.int32,
             f"{name}: retrieval {tuple(v.shape)} {i.dtype}")
        need(bool((i >= 1).all() and (i <= n_items).all()),
             f"{name}: ids outside 1..{n_items}")
        need(bool((v[:, :-1] >= v[:, 1:]).all()), f"{name}: scores not "
             "in descending order")
        got = v
    else:
        need(got.shape == (rows, slate), f"{name}: scores "
             f"{tuple(got.shape)}, want ({rows}, {slate})")
    need(bool(got.isfinite().all()), f"{name}: non-finite scores")


def _same_as_plain(name, got, want) -> None:
    """Outputs bit-identical to the plain twin's."""
    import torch
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        err = float((g - w).to(torch.float32).abs().max())
        need(torch.equal(g, w), f"{name}: differs from the plain twin's "
             f"(max abs err {err:.3g})")


def _to(tree, device):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.to(device), tree)


def serve_recsys(records: dict) -> None:
    """Every recsys kind at full width through
    ``launch/workloads.build_workload``: serve_p99 (8 batches of 512),
    serve_bulk (1 of 262,144) and retrieval_cand (4 single queries
    against 1,000,000 candidates, top-100), each after one warm-up call,
    with every kernel count zeroed just before and read just after
    (the bag: 2 launches a Wide&Deep serve batch, 1 a query; 0 for
    SASRec, MIND and BST, whose paths reach no kernel); Wide&Deep's
    batches again with the plain bag (bit-identical outputs); then each
    kind at smoke size on the card against the CPU."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch, get_shape, smoke_config
    from repro_torch.launch.workloads import (SERVE_SLATE, build_recsys,
                                              build_workload)

    launches = 0
    t_phase = time.monotonic()
    for arch in RECSYS_ARCHS:
        cfg = get_arch(arch)
        for shape, n in RECSYS_RUNS:
            name = f"serve recsys {arch}:{shape}"
            t0 = time.monotonic()
            wl = build_workload(arch, shape, device="cuda", seed=WD_SEED)
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
            per = 0 if cfg.kind != "wide_deep" else \
                1 if shape == "retrieval_cand" else 2
            need(counts["embedding_bag"] == per * n, f"{name}: "
                 f"embedding_bag launches {counts['embedding_bag']}, "
                 f"want {per} x {n}")
            need(all(v == 0 for k, v in counts.items()
                     if k != "embedding_bag"),
                 f"{name}: other kernels launched: {counts}")
            launches += counts["embedding_bag"]
            rows = next(iter(first.values())).shape[0]
            for j, o in enumerate(outs):
                _check_outputs(f"{name} batch {j}", o, rows,
                               SERVE_SLATE[cfg.kind], cfg.n_items)
            twin = ""
            if per:
                with plain_bag():
                    plain = [wl.fn(params, b) for b in batches]
                torch.cuda.synchronize()
                for j, (o, pl) in enumerate(zip(outs, plain)):
                    _same_as_plain(f"{name} batch {j}", o, pl)
                twin = "; outputs bit-identical to the plain twin's"
                del plain
            rate = wl.model_flops * n / (sum(ms) / 1e3)
            lat = (f"latency per batch p50 {np.percentile(ms, 50):.3f} ms "
                   f"p99 {np.percentile(ms, 99):.3f} ms" if n > 1 else
                   f"wall {ms[0]:.3f} ms")
            if shape == "retrieval_cand":
                lat = (f"wall per query {', '.join(f'{x:.3f}' for x in ms)}"
                       f" ms (mean {np.mean(ms):.3f})")
            gib = 2 ** 30
            print(f"[{name}] {n} x {rows} rows: {lat}; embedding_bag "
                  f"launches {counts['embedding_bag']}; peak memory "
                  f"{peak / gib:.2f} GiB, {(peak - base) / gib:.2f} GiB "
                  f"above the {base / gib:.2f} GiB held before the run "
                  f"(earlier phases' data, the parameters, the batches); "
                  f"model {wl.model_flops:.4g} flop a call, "
                  f"{rate / 1e12:.3f} TFLOP/s; built and warmed up in "
                  f"{build_s:.1f}s{twin}")
            del wl, params, batches, first, outs
            torch.cuda.empty_cache()
    records["embedding_bag"]["launches"] = launches

    # small input: the card (kernel) against the CPU (plain), same weights
    for arch in RECSYS_ARCHS:
        cfg = smoke_config(arch)
        wl = build_recsys(cfg, get_shape(cfg, "serve_p99"), device="cuda")
        got = wl.fn(*wl.args).cpu()
        want = wl.fn(*(_to(a, "cpu") for a in wl.args))
        err = float((got - want).abs().max())
        need(got.shape == want.shape and err <= SCORE_TOL,
             f"smoke {arch} card vs CPU: {err:.3g}")
        print(f"[serve recsys] smoke {arch} serve_p99 on the card vs the "
              f"CPU, same weights: max abs err {err:.3g}")
    print(f"[serve recsys] phase {time.monotonic() - t_phase:.1f}s")


def _time_bag_train(cfg, params, batch, rec) -> None:
    """The bag's forward (the kernel, at the path's groups) and backward
    (``embedding_bag_backward``, ``index_add_``) on one train batch's
    deep and wide calls, timed in turns, each beside its bound (each
    input read once, the output written once: the forward reads the
    distinct rows the ids name, the backward writes the whole (V, d)
    gradient, which dominates)."""
    import torch
    from repro_torch.kernels.embedding_bag import kernel as K
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_backward
    from repro_torch.models import recsys
    gids = recsys._wd_field_ids(cfg, batch["sparse_ids"])
    m = cfg.multi_hot
    ids = gids.reshape(-1, m).to(torch.int32).contiguous()
    B = ids.shape[0]
    for table_name, mode in (("tables", "mean"), ("wide", "sum")):
        table = params[table_name].detach()
        V, d = table.shape
        w = recsys.bag_weights(gids, batch["sparse_mask"], mode) \
            .reshape(-1, m).contiguous()
        g = torch.randn((B, d), device="cuda")
        label = f"train_batch {'deep' if mode == 'mean' else 'wide'}"
        res = _turns(rec, f"embedding_bag {label}", {
            "forward": lambda i: K.embedding_bag(table, ids, w,
                                                 cfg.n_sparse),
            "backward": lambda i: embedding_bag_backward(g, ids, w, V)}, 5)
        rows = int(torch.unique(ids).numel())
        fwd_bound, fwd_by = bound(rows * d * 4 + B * m * 8 + B * d * 4,
                                  2 * B * m * d, "float32")
        bwd_bound, bwd_by = bound(B * d * 4 + B * m * 8 + V * d * 4,
                                  2 * B * m * d, "float32")
        for part, bnd, by in (("forward", fwd_bound, fwd_by),
                              ("backward", bwd_bound, bwd_by)):
            rec.setdefault("calls", []).append({
                "call": f"{label} {part}" + (" (index_add_)"
                                             if part == "backward" else ""),
                "ms": res[part]["median"], "bound_ms": bnd,
                "bound_by": by})
        print(f"[train recsys] embedding_bag {label} ({B} bags of {m}, "
              f"table {V} x {d}): forward {res['forward']['median']:.4f} "
              f"ms (bound {fwd_bound:.4f}), backward (index_add_) "
              f"{res['backward']['median']:.4f} ms (bound {bwd_bound:.4f},"
              f" {bwd_by}); card time, in turns")


TRAIN_GRAD_TOL = 1e-5      # a gradient leaf, against its largest |g|
TRAIN_NORM_RTOL = 1e-5     # grad_norm
TRAIN_PARAM_TOL = 1e-2     # params and master after a step, times lr


def _train_step_vs_plain(cfg, params, opt_state, batch) -> None:
    """Wide&Deep's training step at full width from the same (params,
    opt_state, batch) twice: as it runs (the bag kernel forward under
    ``EmbeddingBag``, the ``index_add_`` backward) and with the plain bag
    differentiated by autograd (``plain_bag``). The step is
    ``make_train_step``'s two halves, ``value_and_grad`` then
    ``update``, so the two runs' gradients can be compared too. The
    losses must be bit-identical (the kernel's forward is); every
    gradient leaf within TRAIN_GRAD_TOL * max|g| of the plain one (the
    scatters add in different orders); grad_norm within
    TRAIN_NORM_RTOL; params and the fp32 master within TRAIN_PARAM_TOL *
    lr, except where the two gradients differ by more than 1e-3 of the
    plain one: there a sum cancels, and Adam's g / (sqrt(v) + eps) on a
    row's first use turns its rounding into a step (counted)."""
    import torch
    from repro_torch.kernels.embedding_bag import kernel as K
    from repro_torch.models import recsys
    from repro_torch.training import optimizer as O
    from repro_torch.tree import flatten_with_path

    adamw = O.AdamWConfig()
    vg = O.value_and_grad(lambda p, b: recsys.train_loss(cfg, p, b))
    runs = {}
    for side in ("kernel", "plain"):
        before = K.launches
        with plain_bag() if side == "plain" else contextlib.nullcontext():
            loss, grads = vg(params, batch)
        new_p, new_s, norm = O.update(grads, opt_state, params, adamw)
        torch.cuda.synchronize()
        runs[side] = (loss, grads, new_p, new_s, norm, K.launches - before)
    (lk, gk, pk, sk, nk, launched), (lp, gp, pp, sp, np_, plain_launched) = \
        runs["kernel"], runs["plain"]
    need(launched == 2 and plain_launched == 0, f"train step vs plain: "
         f"{launched} and {plain_launched} bag launches, want 2 and 0")
    need(torch.equal(lk, lp), f"train step vs plain: loss {float(lk)!r} "
         f"against {float(lp)!r}")
    norm_err = abs(float(nk) - float(np_)) / float(np_)
    need(norm_err <= TRAIN_NORM_RTOL, f"train step vs plain: grad_norm "
         f"{float(nk)!r} against {float(np_)!r}")
    worst, cancels, n_el, rounding = 0.0, 0, 0, {}
    gplain = dict(flatten_with_path(gp))
    for path, g in flatten_with_path(gk):
        want = gplain[path]
        scale = float(want.abs().max())
        err = float((g - want).abs().max())
        need(g.shape == want.shape and err <= TRAIN_GRAD_TOL * scale,
             f"train step vs plain: gradient {'/'.join(path)} max abs err "
             f"{err:.3g} against {TRAIN_GRAD_TOL} x {scale:.3g}")
        worst = max(worst, err / scale if scale else err)
        rounding[path] = (g - want).abs() > 1e-3 * want.abs()
    tol = TRAIN_PARAM_TOL * adamw.lr
    for what, a_tree, b_tree in (("params", pk, pp),
                                 ("master", sk["master"], sp["master"])):
        b_flat = dict(flatten_with_path(b_tree))
        for path, a in flatten_with_path(a_tree):
            far = (a - b_flat[path]).abs() > tol
            n_el += a.numel()
            need(not bool((far & ~rounding[path]).any()),
                 f"train step vs plain: {what} {'/'.join(path)} differ by "
                 f"more than {tol:.3g} where the gradients agree")
            cancels += int(far.sum())
    print(f"[train recsys] {cfg.name} step vs the plain bag under autograd"
          f", same (params, opt_state, batch): bag launches {launched} and "
          f"{plain_launched}; loss bit-identical ({float(lk):.7f}); "
          f"grad_norm {float(nk):.6f} against {float(np_):.6f} (rel err "
          f"{norm_err:.3g}, tol {TRAIN_NORM_RTOL}); gradient leaves within "
          f"{worst:.3g} x their max |g| (tol {TRAIN_GRAD_TOL}); params and "
          f"master within {tol:.3g} but {cancels} of {n_el} elements, each "
          f"where the two gradients differ by more than 1e-3 of the plain")
    del runs, gk, gp, pk, pp, sk, sp


def _train_loop_resume(arch: str) -> None:
    """``train_loop.train`` at full width with a checkpoint: an
    uninterrupted 3-step run, a run whose data fails at step 3
    (checkpointed at step 2) and a new run that resumes from that
    checkpoint; the resumed step 3's loss must be the uninterrupted
    run's within rtol 1e-5 (the backward's atomics add in another order
    each run)."""
    import shutil
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.distributed import checkpoint as ckpt
    from repro_torch.launch.workloads import build_workload
    from repro_torch.models import recsys
    from repro_torch.training import train_loop as TL
    cfg = get_arch(arch)
    wl = build_workload(arch, "train_batch", device="cuda", seed=WD_SEED)
    params, _, first = wl.args
    data = [first, next(wl.batches), next(wl.batches)]
    ck_dir = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(ck_dir, ignore_errors=True)

    def loss_fn(p, b):
        return recsys.train_loss(cfg, p, b)

    def preempted():
        yield from data[:2]
        raise RuntimeError("preempted")
    tcfg = TL.TrainConfig(n_steps=3, ckpt_every=2, log_every=1,
                          warmup_steps=1)
    t0 = time.monotonic()
    _, _, full = TL.train(loss_fn, params, iter(data), tcfg)
    t1 = time.monotonic()
    ck = dataclasses.replace(tcfg, ckpt_dir=str(ck_dir))
    try:
        TL.train(loss_fn, params, preempted(), ck)
        need(False, "the preempted run did not stop")
    except RuntimeError as e:
        need("preempted" in str(e), f"train: {e!r}")
    t2 = time.monotonic()
    need(ckpt.latest_step(ck_dir) == 2, "no step-2 checkpoint")
    size = sum(f.stat().st_size for f in (ck_dir / "step_00000002")
               .iterdir())
    _, opt_state, hist = TL.train(loss_fn, params, iter(data[2:]), ck)
    torch.cuda.synchronize()
    t3 = time.monotonic()
    need([h["step"] for h in hist] == [3] and int(opt_state["step"]) == 3,
         f"resume: {hist}")
    want, got = full[-1]["loss"], hist[-1]["loss"]
    need(math.isfinite(got) and abs(got - want) <= 1e-5 * abs(want),
         f"resumed step 3 loss {got!r} vs uninterrupted {want!r}")
    losses = ", ".join(f"{h['loss']:.6f}" for h in full)
    print(f"[train recsys] {arch} train_loop.train at full width: losses "
          f"{losses}; 3 steps "
          f"{t1 - t0:.1f}s; preempted at step 3 after a step-2 checkpoint "
          f"({size / 2**30:.2f} GiB) in {t2 - t1:.1f}s; resumed step 3 "
          f"(restore, step, save) in {t3 - t2:.1f}s: loss {got:.7f} "
          f"against the uninterrupted run's {want:.7f}")
    shutil.rmtree(ck_dir, ignore_errors=True)


def train_recsys(records: dict) -> None:
    """Every recsys kind's ``train_batch`` workload (65,536 rows, AdamW)
    at full width: one warm-up step, then TRAIN_STEPS steps with every
    kernel count zeroed just before and read just after; loss and
    grad_norm finite, every parameter leaf changed, the bag launched
    twice a Wide&Deep step (its forward, under autograd) and never
    elsewhere. Wide&Deep's step held against the plain bag under
    autograd from the same state (``_train_step_vs_plain``), and its bag
    forward and backward timed in turns at the step's shapes; then
    Wide&Deep through ``train_loop.train`` with
    a checkpoint and a resume."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch.workloads import build_workload
    from repro_torch.tree import leaves

    t_phase = time.monotonic()
    launches = 0
    for arch in RECSYS_ARCHS:
        cfg = get_arch(arch)
        name = f"train recsys {arch}:train_batch"
        t0 = time.monotonic()
        wl = build_workload(arch, "train_batch", device="cuda", seed=WD_SEED)
        params0, opt_state, first = wl.args
        params, opt_state, _ = wl.fn(params0, opt_state, first)
        torch.cuda.synchronize()
        build_s = time.monotonic() - t0
        batches = [next(wl.batches) for _ in range(TRAIN_STEPS)]
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_counts()
        ms, metrics = [], []
        for b in batches:
            t1 = time.monotonic()
            params, opt_state, m = wl.fn(params, opt_state, b)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.monotonic() - t1))
            metrics.append({k: float(v) for k, v in m.items()})
        counts = {k: mod.launches for k, mod in kernel_counters().items()}
        peak = torch.cuda.max_memory_allocated()
        per = 2 if cfg.kind == "wide_deep" else 0
        need(counts["embedding_bag"] == per * TRAIN_STEPS,
             f"{name}: embedding_bag launches {counts['embedding_bag']}, "
             f"want {per} x {TRAIN_STEPS}")
        need(all(v == 0 for k, v in counts.items() if k != "embedding_bag"),
             f"{name}: other kernels launched: {counts}")
        launches += counts["embedding_bag"]
        need(all(math.isfinite(x["loss"]) and math.isfinite(x["grad_norm"])
                 for x in metrics), f"{name}: {metrics}")
        need(int(opt_state["step"]) == TRAIN_STEPS + 1,
             f"{name}: step {int(opt_state['step'])}")
        same = [i for i, (a, b) in enumerate(zip(leaves(params0),
                                                 leaves(params)))
                if torch.equal(a, b)]
        need(not same, f"{name}: parameter leaves {same} unchanged")
        gib = 2 ** 30
        losses = ", ".join(f"{x['loss']:.5f}" for x in metrics)
        norms = ", ".join(f"{x['grad_norm']:.4f}" for x in metrics)
        print(f"[{name}] {TRAIN_STEPS} steps of "
              f"{next(iter(first.values())).shape[0]} rows: wall a step "
              f"{', '.join(f'{x:.1f}' for x in ms)} ms (mean "
              f"{np.mean(ms):.1f}); loss {losses}; grad_norm {norms}; all "
              f"{len(leaves(params))} parameter leaves changed; "
              f"embedding_bag launches {counts['embedding_bag']}; peak "
              f"memory {peak / gib:.2f} GiB, {(peak - base) / gib:.2f} GiB "
              f"above the {base / gib:.2f} GiB held before the steps; model "
              f"{wl.model_flops:.4g} flop a step, "
              f"{wl.model_flops / (np.mean(ms) / 1e3) / 1e12:.3f} TFLOP/s; "
              f"built and warmed up in {build_s:.1f}s")
        if cfg.kind == "wide_deep":
            _train_step_vs_plain(cfg, params, opt_state, batches[0])
            _time_bag_train(cfg, params, batches[0], records["embedding_bag"])
        del wl, params0, params, opt_state, first, batches
        torch.cuda.empty_cache()
    records["embedding_bag"]["launches"] += launches
    records["embedding_bag"]["train_launches"] = launches
    _train_loop_resume(WD_ARCH)
    print(f"[train recsys] phase {time.monotonic() - t_phase:.1f}s")


# ---------------------------------------------------------------------------
# phase 7b: train gnn
# ---------------------------------------------------------------------------

GNN_ARCH = "graphsage-reddit"   # configs/other_archs.py, full width
GNN_SEED = 0
GNN_STEPS = 3                   # timed AdamW steps a shape
GNN_RTOL = 1e-5                 # loss and grad_norm, card vs CPU
GNN_GRAD_TOL = 1e-4             # a gradient leaf, against its max |g|
AGG64_RTOL = 1e-5               # ogb_products layer 0, fp32 vs fp64
AGG64_CHUNK = 1 << 23           # edges a chunk of the fp64 twin
# peak device memory of a step, reckoned: ogb_products' layer-2 messages
# (E, 128) fp32 31.7 GB, their gradient in the backward, the features,
# the int64 indices
GNN_PEAK_RECKONED = {"ogb_products": "35-45 GB"}


def _gnn_traffic(cfg, shape, d_feat: int) -> float:
    """Bytes a GraphSAGE step's gathers and segment sums move on the
    card: each gather reads and writes the (E, F) messages, each segment
    sum reads them and adds them into the output; the backward does the
    same for every layer whose input needs a gradient (not layer 0's
    features); plus the int64 indices read by each. The minibatch
    regime gathers on the host (the sampler) and averages densely on the
    card: 0."""
    if shape.kind == "minibatch":
        return 0.0
    E = shape.n_edges * (shape.global_batch or 1)
    widths = [d_feat] + [cfg.d_hidden] * (cfg.n_layers - 1)
    total = 0.0
    for i, F in enumerate(widths):
        passes = 2 if i == 0 else 4          # gather + sum, x2 in backward
        total += passes * (2 * E * F * 4 + E * 8) + 2 * E * (4 + 8)  # + deg
    return total


def _f64(tree):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.cpu().double() if t.is_floating_point()
                    else t.cpu(), tree)


def _gnn_card_vs_cpu(label, cfg, loss_fn, params, batch) -> str:
    """``train_loss`` and every gradient leaf on the card against the
    CPU from the same weights and batch, both fp32 (the card's segment
    sums add by atomics, in another order). Not against an fp64 twin: a
    leaf that is a sum with cancellation (``minibatch_lg``'s layer-0
    bias: max |g| 1.1e-3) sits 3.2e-4 x max |g| from fp64 in both fp32
    runs alike. Two fp32 runs can still part where a pre-activation
    lies within rounding of 0 (``_gnn_relu_band``)."""
    from repro_torch.training import optimizer as O
    from repro_torch.tree import flatten_with_path
    vg = O.value_and_grad(lambda p, b: loss_fn(cfg, p, b))
    lg, gg = vg(params, batch)
    lc, g_cpu = vg(_to(params, "cpu"), _to(batch, "cpu"))
    ng, nc = float(O._global_norm(gg)), float(O._global_norm(g_cpu))
    el = abs(float(lg) - float(lc)) / abs(float(lc))
    en = abs(ng - nc) / nc
    need(el <= GNN_RTOL and en <= GNN_RTOL, f"{label}: loss {float(lg)!r} "
         f"/ {float(lc)!r}, grad_norm {ng!r} / {nc!r} (card / CPU)")
    worst = 0.0
    want = dict(flatten_with_path(g_cpu))
    for path, g in flatten_with_path(gg):
        w = want[path]
        scale = float(w.abs().max())
        err = float((g.cpu() - w).abs().max())
        need(err <= GNN_GRAD_TOL * scale + 1e-7, f"{label}: gradient "
             f"{'/'.join(path)} max abs err {err:.3g} against "
             f"{GNN_GRAD_TOL} x {scale:.3g}")
        worst = max(worst, err / scale if scale else err)
    return (f"card vs CPU, same weights and batch: loss rel err {el:.3g}, "
            f"grad_norm rel err {en:.3g} (tol {GNN_RTOL}), gradient leaves "
            f"within {worst:.3g} x their max |g| (tol {GNN_GRAD_TOL})")


GNN_BAND_SEED = 1     # the smoke-width full_graph_sm whose CPU fp32
                      # gradients strayed (a first card-test run)


def _gnn_relu_band() -> str:
    """Why two fp32 runs of a GraphSAGE step can disagree past 1e-4 x
    max |g| with neither at fault: at the smoke width (d_hidden 16),
    ``full_graph_sm``, seed GNN_BAND_SEED, layer 0's pre-activations
    (``_sage_layer``'s ``h_self @ w_self + h_agg @ w_neigh + bias``)
    from the CPU in fp32 and fp64, the card in fp32, and the CPU in fp32
    with the edges in three permuted orders: the elements whose ReLU
    side differs from fp64's (node, unit, values, that node's ReLU
    output norm and positive units), and each run's worst gradient leaf
    against fp64."""
    import torch
    from repro_torch.configs import get_arch, get_shape, smoke_config
    from repro_torch.launch.workloads import build_gnn
    from repro_torch.models import gnn
    from repro_torch.training import optimizer as O
    from repro_torch.tree import flatten_with_path

    cfg = smoke_config(GNN_ARCH)
    wl = build_gnn(cfg, get_shape(get_arch(GNN_ARCH), "full_graph_sm"),
                   device="cpu", seed=GNN_BAND_SEED)
    params, _, batch = wl.args
    vg = O.value_and_grad(lambda p, b: gnn.full_graph_loss(cfg, p, b))
    layer = gnn._sage_layer

    def run(p, b):
        pre = []

        def sage(cfg_, p_, h_self, h_agg, last):
            if not pre:
                pre.append((h_self @ p_["w_self"] + h_agg @ p_["w_neigh"]
                            + p_["bias"]).detach().cpu().double())
            return layer(cfg_, p_, h_self, h_agg, last)
        gnn._sage_layer = sage
        try:
            _, g = vg(p, b)
        finally:
            gnn._sage_layer = layer
        return pre[0], dict(flatten_with_path(g))

    pre64, g64 = run(_f64(params), _f64(batch))
    gen = torch.Generator().manual_seed(GNN_BAND_SEED)
    runs = {"CPU fp32": (params, batch),
            "card fp32": (_to(params, "cuda"), _to(batch, "cuda"))}
    for i in range(3):
        perm = torch.randperm(batch["edges"].shape[0], generator=gen)
        runs[f"CPU fp32, edges permuted ({i + 1})"] = (params, dict(
            batch, edges=batch["edges"][perm],
            edge_mask=batch["edge_mask"][perm]))
    parts = []
    for name, (p, b) in runs.items():
        pre, g = run(p, b)
        worst = max((float((g[k].cpu().double() - w).abs().max())
                     / float(w.abs().max()), "/".join(k))
                    for k, w in g64.items())
        flips = ((pre > 0) != (pre64 > 0)).nonzero().tolist()
        where = "; ".join(
            f"node {n} unit {u}: fp64 {float(pre64[n, u]):.3g}, this run "
            f"{float(pre[n, u]):.3g}, the node's ReLU output norm "
            f"{float(pre64[n].clamp(min=0).norm()):.3g} over "
            f"{int((pre64[n] > 0).sum())} positive units"
            for n, u in flips[:3])
        parts.append(f"{name}: worst leaf {worst[1]} {worst[0]:.3g} x max "
                     f"|g| from fp64; {len(flips)} ReLU side(s) unlike "
                     f"fp64's{': ' + where if where else ''}")
    scale = float(pre64.abs().max())
    near = int(pre64.abs().argmin())
    n, u = divmod(near, pre64.shape[1])
    return (f"smoke width (d_hidden {cfg.d_hidden}) full_graph_sm seed "
            f"{GNN_BAND_SEED}, layer 0 pre-activations (max |x| "
            f"{scale:.3g}, fp32 ulp there {scale * 2 ** -23:.3g}; nearest "
            f"0: node {n} unit {u}, {float(pre64[n, u]):.3g}): "
            + " | ".join(parts))


def _agg64_check(cfg, batch) -> str:
    """Layer 0's aggregation of the full graph (the mean over in-edges,
    masked edges to the trash segment) in fp32 on the card against the
    same computed in fp64 on the card, edge chunk by edge chunk."""
    import torch
    from repro_torch.models import gnn
    feats, edges, mask = batch["feats"], batch["edges"], batch["edge_mask"]
    n = feats.shape[0]
    src = torch.where(mask, edges[:, 0], n).long()
    dst = torch.where(mask, edges[:, 1], n).long()
    hp = torch.cat([feats, feats.new_zeros((1, feats.shape[1]))])
    with torch.no_grad():
        agg = gnn._aggregate(cfg, hp, src, dst, n + 1)[:n]
        hp64 = hp.double()
        acc = torch.zeros((n + 1, hp.shape[1]), dtype=torch.float64,
                          device=hp.device)
        deg = torch.zeros((n + 1,), dtype=torch.float64, device=hp.device)
        for c in range(0, src.numel(), AGG64_CHUNK):
            s, d = src[c:c + AGG64_CHUNK], dst[c:c + AGG64_CHUNK]
            acc.index_add_(0, d, hp64[s])
            deg.index_add_(0, d, torch.ones_like(d, dtype=torch.float64))
        want = (acc / deg.clamp(min=1.0)[:, None])[:n]
        rel = float((agg.double() - want).abs().max() / want.abs().max())
    need(rel <= AGG64_RTOL, f"ogb_products layer 0 aggregation: rel err "
         f"{rel:.3g} against fp64 > {AGG64_RTOL}")
    del src, dst, hp, agg, hp64, acc, want
    return (f"layer 0's aggregation ({cfg.aggregator} over "
            f"{edges.shape[0]:,} edges) against the fp64 twin: rel err "
            f"{rel:.3g} (tol {AGG64_RTOL})")


def train_gnn(records: dict) -> None:
    """GraphSAGE (``graphsage-reddit``: 2 layers, d_hidden 128, mean, 41
    classes) at every ``GNN_SHAPES`` entry at its published size, through
    ``launch/workloads.build_gnn``: full_graph_sm, molecule and
    minibatch_lg's batch held card against CPU (``_gnn_card_vs_cpu``),
    ogb_products' layer 0 against fp64 (``_agg64_check``); then
    GNN_STEPS AdamW steps each, timed by CUDA events, with every kernel
    count zeroed before and read after (no hand-written kernel is on
    this path: the reference's gathers and segment sums are XLA ops):
    losses finite, the peak memory, the bytes the gathers and segment
    sums move against the HBM rate; last, ``_gnn_relu_band``."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import GNN_SHAPES, get_arch
    from repro_torch.launch.workloads import build_gnn
    from repro_torch.models import gnn

    t_phase = time.monotonic()
    cfg = get_arch(GNN_ARCH)
    losses = {"full_graph": gnn.full_graph_loss,
              "minibatch": gnn.minibatch_loss,
              "batched_graphs": gnn.batched_graphs_loss}
    gib = 2 ** 30
    for shape in GNN_SHAPES:
        label = f"train gnn {shape.name}"
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        wl = build_gnn(cfg, shape, device="cuda", seed=GNN_SEED)
        params, opt_state, batch = wl.args
        batches = [batch] + [next(wl.batches) for _ in range(GNN_STEPS - 1)]
        torch.cuda.synchronize()
        build_s = time.monotonic() - t0
        d_feat = params["layers"][0]["w_self"].shape[0]
        if shape.kind == "minibatch":
            print(f"[{label}] sampler graph on the host: "
                  f"{shape.n_nodes:,} nodes, average degree "
                  f"{-(-shape.n_edges // shape.n_nodes)} (not cut); built "
                  f"with its first batches in {build_s:.1f}s")
        else:
            print(f"[{label}] built in {build_s:.1f}s (graph, batch and "
                  f"weights on the card)")
        if shape.name == "ogb_products":
            check = _agg64_check(cfg, batch)
        else:
            check = _gnn_card_vs_cpu(label, cfg, losses[shape.kind], params,
                                     batch)
        print(f"[{label}] {check}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_counts()
        ms, metrics = [], []
        t0e = torch.cuda.Event(enable_timing=True)
        t1e = torch.cuda.Event(enable_timing=True)
        for b in batches:
            t0e.record()
            params, opt_state, m = wl.fn(params, opt_state, b)
            t1e.record()
            t1e.synchronize()
            ms.append(t0e.elapsed_time(t1e))
            metrics.append({k: float(v) for k, v in m.items()})
        counts = {k: mod.launches for k, mod in kernel_counters().items()}
        peak = torch.cuda.max_memory_allocated()
        need(all(v == 0 for v in counts.values()),
             f"{label}: hand-written kernels launched: {counts}")
        need(all(math.isfinite(x["loss"]) and math.isfinite(x["grad_norm"])
                 for x in metrics), f"{label}: {metrics}")
        need(int(opt_state["step"]) == GNN_STEPS,
             f"{label}: step {int(opt_state['step'])}")
        moved = _gnn_traffic(cfg, shape, d_feat)
        at_rate = 1e3 * moved / HBM_BYTES_PER_S
        E = shape.n_edges * (shape.global_batch or 1)
        msgs = 4 * E * max(d_feat, cfg.d_hidden)
        batch_b = sum(t.numel() * t.element_size() for t in batch.values())
        walls = ", ".join(f"{x:.3f}" for x in ms)
        loss_s = ", ".join(f"{x['loss']:.5f}" for x in metrics)
        norm_s = ", ".join(f"{x['grad_norm']:.4f}" for x in metrics)
        print(f"[{label}] {GNN_STEPS} AdamW steps: wall a step {walls} ms "
              f"(CUDA events; mean of the last {GNN_STEPS - 1} "
              f"{np.mean(ms[1:]):.3f}); loss {loss_s}; grad_norm {norm_s}"
              f"; kernel launches {json.dumps(counts)}; peak memory "
              f"{peak / gib:.2f} GiB ({(peak - base) / gib:.2f} above the "
              f"{base / gib:.2f} held before the steps; reckoned "
              f"{GNN_PEAK_RECKONED.get(shape.name, 'not reckoned')}: the "
              f"batch "
              f"{batch_b / gib:.3f} GiB, the widest message tensor (E x "
              f"max(d_feat, d_hidden) fp32) {msgs / gib:.2f} GiB); "
              f"gathers and segment sums move {moved / 1e9:.3f} GB a step: "
              f"{at_rate:.3f} ms at {HBM_BYTES_PER_S / 1e12:.2f} TB/s "
              f"({100 * at_rate / np.mean(ms[1:]):.1f} % of the step); "
              f"model {wl.model_flops:.4g} flop a step")
        del wl, params, opt_state, batch, batches, m
    print(f"[train gnn] ReLU band: {_gnn_relu_band()}")
    print(f"[train gnn] phase {time.monotonic() - t_phase:.1f}s")


# ---------------------------------------------------------------------------
# phase 7c: train lm
# ---------------------------------------------------------------------------

LM_TRAIN_BATCH = 2          # train_4k's global batch of 256, cut
LM_TRAIN_STEPS = 3
LM_LOSS_RTOL = 2e-2         # bf16 step 1, kernel vs plain attention
LM_NORM_RTOL = 5e-2
MOE_TRAIN_LAYERS = 2        # Qwen2-MoE-A2.7B's 24 layers, cut to fit
MOE_TRAIN_SEQ = 1024
PREFILL_BATCH, DECODE_BATCH = 1, 8    # prefill_32k's 32, decode_32k's 128
PLAIN_Q_CHUNK = 2048        # query rows a block of the plain 32k twin
LM_PEAK_RECKONED = "62-68 GiB"


@contextlib.contextmanager
def plain_attention(prefill_attention=None):
    """Swap the transformer's attention for the plain version (under
    autograd, autograd differentiates it directly) and its decode
    attention for the plain decode version; the swapped-in functions
    count no launches. ``prefill_attention`` replaces the plain
    attention where its (S, S) scores would not fit (S = 32,768)."""
    from repro_torch.models import attention as plain
    from repro_torch.models import transformer as tr
    saved = tr.attention, tr.decode_attention
    tr.attention = prefill_attention or plain.causal_attention
    tr.decode_attention = lambda q, kc, vc, n: plain.decode_attention(
        q[:, None], kc, vc, n)[:, 0]
    try:
        yield
    finally:
        tr.attention, tr.decode_attention = saved


def plain_attention_by_query_blocks(q, k, v):
    """The plain causal attention (``models/attention.causal_attention``'s
    math, fp32) a block of PLAIN_Q_CHUNK query rows at a time, each
    against the keys up to its last row, so the scores of a block are
    (B, K, G, chunk, <= S): the plain twin at S = 32,768."""
    import torch
    from repro_torch.models.attention import NEG_INF
    B, S, H, D = q.shape
    K = k.shape[2]
    G = H // K
    out = torch.empty_like(q)
    kf, vf = k.float(), v.float()
    for i0 in range(0, S, PLAIN_Q_CHUNK):
        i1 = min(S, i0 + PLAIN_Q_CHUNK)
        qg = q[:, i0:i1].float().reshape(B, i1 - i0, K, G, D)
        s = torch.einsum("bskgd,btkd->bkgst", qg, kf[:, :i1]) * D ** -0.5
        pos_q = torch.arange(i0, i1, device=q.device)[:, None]
        pos_k = torch.arange(i1, device=q.device)[None, :]
        s = s.masked_fill(pos_q < pos_k, NEG_INF)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgst,btkd->bskgd", p, vf[:, :i1])
        out[:, i0:i1] = o.reshape(B, i1 - i0, H, D).to(q.dtype)
        del s, p, o
    return out


def _lm_step_vs_plain(label, cfg, wl, steps: int, flash_per_step: int,
                      records: dict) -> dict:
    """``wl`` (a ``build_lm`` train workload on the card): step 1's loss
    and grad_norm of a plain twin (the same weights and batch, plain
    attention under autograd: ``value_and_grad`` and the global norm),
    then ``steps`` AdamW steps through ``wl.fn`` with the flash kernel
    under ``FlashAttention``, every count zeroed just before and read
    just after, each step timed by CUDA events; flash launches must be
    ``flash_per_step`` a step and nothing else launched. Returns the
    step times and the peak memory."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models import transformer as tr
    from repro_torch.training import optimizer as O

    params, opt_state, first = wl.args
    wl.args = None          # the caller's copy would keep the first state
    t0 = time.monotonic()
    batches = [first] + [next(wl.batches) for _ in range(steps - 1)]
    draw_s = time.monotonic() - t0
    before = fk.launches
    with plain_attention():
        loss_p, grads = O.value_and_grad(
            lambda p, b: tr.train_loss(cfg, p, b))(params, first)
        norm_p = float(O._global_norm(grads))
    loss_p = float(loss_p)
    del grads
    need(fk.launches == before, f"{label}: the plain twin launched flash")
    gc_collect()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts()
    ms, metrics, per_step = [], [], []
    t0e = torch.cuda.Event(enable_timing=True)
    t1e = torch.cuda.Event(enable_timing=True)
    for b in batches:
        n0 = fk.launches
        t0e.record()
        params, opt_state, m = wl.fn(params, opt_state, b)
        t1e.record()
        t1e.synchronize()
        ms.append(t0e.elapsed_time(t1e))
        metrics.append({k: float(v) for k, v in m.items()})
        per_step.append(fk.launches - n0)
    counts = {k: mod.launches for k, mod in kernel_counters().items()}
    peak = torch.cuda.max_memory_allocated()
    need(per_step == [flash_per_step] * steps,
         f"{label}: flash launches a step {per_step}, want "
         f"{flash_per_step}")
    need(all(v == 0 for k, v in counts.items() if k != "flash_attention"),
         f"{label}: other kernels launched: {counts}")
    rec = records["flash_attention"]
    rec.setdefault("launches_by_run", {})[label] = counts["flash_attention"]
    rec["launches"] = sum(rec["launches_by_run"].values())
    need(all(math.isfinite(x["loss"]) and math.isfinite(x["grad_norm"])
             for x in metrics), f"{label}: {metrics}")
    el = abs(metrics[0]["loss"] - loss_p) / abs(loss_p)
    en = abs(metrics[0]["grad_norm"] - norm_p) / norm_p
    need(el <= LM_LOSS_RTOL and en <= LM_NORM_RTOL,
         f"{label}: step 1 loss {metrics[0]['loss']!r} / plain {loss_p!r}, "
         f"grad_norm {metrics[0]['grad_norm']!r} / plain {norm_p!r}")
    B, S = first["tokens"].shape
    tokens = B * S
    n_params = cfg.param_count()
    wall = float(np.mean(ms[1:] or ms))
    mfu = 6 * n_params * tokens / (wall / 1e3 * PEAK_OPS_PER_S["bfloat16"])
    walls = ", ".join(f"{x:.1f}" for x in ms)
    loss_s = ", ".join(f"{x['loss']:.5f}" for x in metrics)
    norm_s = ", ".join(f"{x['grad_norm']:.4f}" for x in metrics)
    print(f"[{label}] {steps} AdamW steps of {B} x {S} tokens (batches "
          f"drawn on the host in {draw_s:.1f}s before the steps): wall a "
          f"step {walls} ms (CUDA events; mean of the last "
          f"{max(1, steps - 1)} {wall:.1f}); loss {loss_s}; grad_norm "
          f"{norm_s}; step 1 "
          f"against the plain twin (plain attention under autograd, same "
          f"weights and batch): loss {loss_p:.5f} (rel err {el:.3g}, tol "
          f"{LM_LOSS_RTOL}), grad_norm {norm_p:.4f} (rel err {en:.3g}, tol "
          f"{LM_NORM_RTOL}); flash launches a step {per_step} (2 a layer: "
          f"forward and the remat recompute); {tokens / (wall / 1e3):,.0f} "
          f"tokens/s; 6 N tokens / (wall x 989 TFLOP/s) = {mfu:.4f} (N "
          f"{n_params:,}); peak memory {peak / 2**30:.2f} GiB "
          f"({(peak - base) / 2**30:.2f} above the {base / 2**30:.2f} held "
          f"before the steps)")
    del params, opt_state, batches, m
    return {"ms": ms, "peak": peak}


def gc_collect() -> None:
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _attn_errs(label: str, out, ref) -> str:
    """``out`` (a kernel's bf16 output) against ``ref`` (the plain
    version's fp32 output on the same inputs): the max abs error within
    ATTN_TOL, as the kernel checks hold it, and each output row's (one
    query position and head: D values) error norm over that row's
    reference norm within ATTN_TOL, which an abs bound alone does not
    give at long S, where an output row averages thousands of values
    and its entries are ~1e-2. Returns both, printed."""
    import torch
    need(out.shape == ref.shape and out.dtype == torch.bfloat16,
         f"{label}: output {out.dtype} {tuple(out.shape)}")
    d = out.detach().float() - ref
    e_abs = float(d.abs().max())
    e_row = float((torch.linalg.vector_norm(d, dim=-1)
                   / torch.linalg.vector_norm(ref, dim=-1)).max())
    need(math.isfinite(e_abs) and math.isfinite(e_row) and e_abs <= ATTN_TOL
         and e_row <= ATTN_TOL, f"{label}: max abs err {e_abs:.3g}, max "
         f"row rel err {e_row:.3g} against the plain version (tol "
         f"{ATTN_TOL} each)")
    return f"max abs err {e_abs:.3g}, max row rel err {e_row:.3g}"


def _flash_train_turns(rec: dict) -> None:
    """The flash kernel under autograd at the train shape (B 2, S 4096,
    H 16, Kv 8, D 128, bf16): the kernel's output, called directly and
    through ``FlashAttention``, against the plain version's (fp32) by
    ``_attn_errs``; q/k/v gradients of ``sum(out**2 * w)`` (so the
    upstream gradient, 2 out w, carries the kernel's output into the
    backward) against the plain version's (fp32, autograd) within
    ATTN_TOL x max |g| and ATTN_TOL in norm; then the forward (the
    kernel) and the forward + backward (``FlashAttention``: the kernel,
    then the plain version recomputed and differentiated) in turns
    beside SDPA's, each beside its bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention.ops import attention
    from repro_torch.models.attention import causal_attention

    B, S, H, Kv, D = LM_TRAIN_BATCH, 4096, 16, 8, 128
    g = torch.Generator(device="cuda").manual_seed(5)

    def r(*shape):
        return torch.randn(shape, generator=g, device="cuda",
                           dtype=torch.bfloat16)
    q, k, v = r(B, S, H, D), r(B, S, Kv, D), r(B, S, Kv, D)
    w = r(B, S, H, D)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref_in = [t.float().requires_grad_(True) for t in (q, k, v)]
    ref = causal_attention(*ref_in)
    before = K.launches
    out_k = K.flash_attention(q, k, v)
    out_f = attention(*leaves)
    need(K.launches == before + 2 and out_f.grad_fn is not None,
         f"flash under autograd: {K.launches - before} launches for the "
         f"direct call and the FlashAttention one, want 2")
    fwd_k = _attn_errs("flash train forward (kernel)", out_k, ref.detach())
    fwd_f = _attn_errs("flash train forward (FlashAttention)", out_f,
                       ref.detach())
    got = torch.autograd.grad((out_f.float() ** 2 * w).sum(), leaves)
    want = torch.autograd.grad((ref ** 2 * w.float()).sum(), ref_in)
    errs = []
    for name, a, b in zip("qkv", got, want):
        d = a.float() - b
        e = float(d.abs().max()) / float(b.abs().max())
        en = float(torch.linalg.vector_norm(d)
                   / torch.linalg.vector_norm(b))
        need(e <= ATTN_TOL and en <= ATTN_TOL,
             f"flash under autograd: d{name} err {e:.3g} x max |g|, "
             f"{en:.3g} in norm (tol {ATTN_TOL} each)")
        errs.append((e, en))
    del got, want, ref_in, ref, out_k, out_f
    gc_collect()
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sd = [t.clone().requires_grad_(True) for t in (qt, kt, vt)]
    wt = w.transpose(1, 2)

    def sdpa(*a):
        return F.scaled_dot_product_attention(*a, is_causal=True,
                                              enable_gqa=True)
    label = f"flash train B={B} S={S}"
    fwd = _turns(rec, f"{label} forward", {
        "kernel": lambda i: K.flash_attention(q, k, v),
        "sdpa": lambda i: sdpa(qt, kt, vt)}, 10)
    both = _turns(rec, f"{label} forward+backward", {
        "kernel (FlashAttention)": lambda i: torch.autograd.grad(
            attention(*leaves), leaves, w),
        "sdpa": lambda i: torch.autograd.grad(sdpa(*sd), sd, wt)}, 3)
    pairs = S * (S + 1) // 2
    io = 2 * (2 * B * S * H * D + 2 * B * S * Kv * D)
    f_ms, f_by = bound(io, 4 * B * H * D * pairs, "bfloat16")
    # backward: q, k, v, o, dO read, dq, dk, dv written; 5 products of
    # the forward's 2 (dV, dP, dS->dQ, dS->dK, and P recomputed)
    b_ms, b_by = bound(io + 2 * (2 * B * S * H * D + 2 * B * S * Kv * D),
                       (4 + 10) * B * H * D * pairs, "bfloat16")
    for part, res, key, bnd, by in (
            ("forward", fwd, "kernel", f_ms, f_by),
            ("forward+backward", both, "kernel (FlashAttention)", b_ms,
             b_by)):
        rec.setdefault("calls", []).append({
            "call": f"{label} {part}", "ms": res[key]["median"],
            "library_ms": res["sdpa"]["median"], "bound_ms": bnd,
            "bound_by": by})
        print(f"[train lm] {label} {part}: kernel {res[key]['median']:.4f} "
              f"ms, SDPA {res['sdpa']['median']:.4f} ms (ratio "
              f"{res[key]['median'] / res['sdpa']['median']:.3f}), bound "
              f"{bnd:.4f} ms ({by}); card time, in turns")
    print(f"[train lm] flash under autograd at B={B} S={S} H={H} Kv={Kv} "
          f"D={D} bf16: forward against the plain version (fp32): kernel "
          f"{fwd_k}, FlashAttention {fwd_f} (tol {ATTN_TOL}); gradients of "
          f"sum(out**2 * w), dq/dk/dv against the plain version's within "
          f"{', '.join(f'{e:.3g}' for e, _ in errs)} x max |g| and "
          f"{', '.join(f'{en:.3g}' for _, en in errs)} in norm (tol "
          f"{ATTN_TOL})")


def _rel_logits(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def _lm_serve_32k(records: dict) -> None:
    """Full-width Qwen3-1.7B at ``prefill_32k`` (B PREFILL_BATCH: flash at
    S = 32,768, a 3.76 GB cache) and ``decode_32k`` (B DECODE_BATCH
    against a 32,768-position cache of seeded random k/v, 30 GB, length
    32,767), each by ``_lm_serve_one``, whose locals (the cache) are
    gone when it returns."""
    for shape_name, B, kname in (
            ("prefill_32k", PREFILL_BATCH, "flash_attention"),
            ("decode_32k", DECODE_BATCH, "decode_attention")):
        _lm_serve_one(records, shape_name, B, kname)
        gc_collect()


def _lm_serve_one(records: dict, shape_name: str, B: int,
                  kname: str) -> None:
    """One 32k shape: a call's launches counted (28 flash a prefill, 28
    decode a step), a second call timed by CUDA events, its logits
    against a plain twin (the prefill's attention a block of query rows
    at a time); flash at S = 32,768 or decode attention at 32,768
    positions held to its plain version (fp32) by ``_attn_errs`` on the
    inputs it is then timed on, in turns beside SDPA."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import QWEN3_1_7B, get_shape
    from repro_torch.kernels.decode_attention import kernel as DK
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.launch.workloads import build_lm
    from repro_torch.models.attention import decode_attention as plain_decode

    cfg = QWEN3_1_7B
    L, H, Kv, D = cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    label = f"train lm {shape_name}"
    gc_collect()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    wl = build_lm(cfg, get_shape(cfg, shape_name), device="cuda",
                  seed=0, batch=B)
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    reset_counts()
    out = wl.fn(*wl.args)
    counts = {k: m.launches for k, m in kernel_counters().items()}
    del out
    # a second call, timed (decode rewrites the same position)
    t0e = torch.cuda.Event(enable_timing=True)
    t1e = torch.cuda.Event(enable_timing=True)
    t0e.record()
    out = wl.fn(*wl.args)
    t1e.record()
    t1e.synchronize()
    call_ms = t0e.elapsed_time(t1e)
    need(counts[kname] == L and all(
        v == 0 for k, v in counts.items() if k != kname),
         f"{label}: launches {counts}, want {L} {kname}")
    rec = records[kname]
    rec.setdefault("launches_by_run", {})[shape_name] = counts[kname]
    rec["launches"] = sum(rec["launches_by_run"].values())
    logits = out[0]
    need(bool(logits.isfinite().all()), f"{label}: logits not finite")
    with plain_attention(plain_attention_by_query_blocks):
        plain_logits = wl.fn(*wl.args)[0]
    rel = _rel_logits(logits, plain_logits)
    need(rel <= LOGIT_REL_TOL, f"{label}: logits rel err {rel:.3g} "
         f"against the plain twin > {LOGIT_REL_TOL}")
    S = get_shape(cfg, shape_name).seq_len
    extra = ""
    if shape_name == "decode_32k":
        cache = wl.args[1]
        extra = (f"; cache {2 * cache['k'].numel() * 2 / 1e9:.2f} GB, "
                 f"length {int(cache['length'][0])}")
    print(f"[{label}] B {B} x S {S}: {call_ms:.1f} ms a call (CUDA "
          f"events, the second call; built in {build_s:.1f}s{extra}); "
          f"{kname} launches in the first call {counts[kname]}; logits "
          f"against the plain twin: rel err {rel:.3g} (tol "
          f"{LOGIT_REL_TOL}); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del out, logits, plain_logits
    g = torch.Generator(device="cuda").manual_seed(6)
    if shape_name == "prefill_32k":
        def r(*s):
            return torch.randn(s, generator=g, device="cuda",
                               dtype=torch.bfloat16)
        q, k, v = r(B, S, H, D), r(B, S, Kv, D), r(B, S, Kv, D)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lab = f"flash B={B} S={S}"
        errs = _attn_errs(lab, FK.flash_attention(q, k, v),
                          plain_attention_by_query_blocks(
                              q.float(), k.float(), v.float()))
        res = _turns(rec, lab, {
            "kernel": lambda i: FK.flash_attention(q, k, v),
            "sdpa": lambda i: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)}, 2)
        pairs = S * (S + 1) // 2
        b_ms, b_by = bound(2 * (2 * B * S * H * D + 2 * B * S * Kv * D),
                           4 * B * H * D * pairs, "bfloat16")
        del q, k, v, qt, kt, vt
    else:
        cache = wl.args[1]
        lens = (cache["length"] + 1).to(torch.int32)
        q = torch.randn((B, H, D), generator=g, device="cuda",
                        dtype=torch.bfloat16)
        qt = q[:, :, None, :]
        lab = f"decode B={B} S={S} cache length {S - 1} + 1 new"
        errs = _attn_errs(lab, DK.decode_attention(
            q, cache["k"][0], cache["v"][0], lens), plain_decode(
            q.float()[:, None], cache["k"][0].float(),
            cache["v"][0].float(), lens)[:, 0])
        res = _turns(rec, lab, {
            "kernel": lambda i: DK.decode_attention(
                q, cache["k"][i % L], cache["v"][i % L], lens),
            "sdpa": lambda i: F.scaled_dot_product_attention(
                qt, cache["k"][i % L].transpose(1, 2),
                cache["v"][i % L].transpose(1, 2), enable_gqa=True)},
            L)
        live = int(lens.sum())
        b_ms, b_by = bound(2 * (2 * B * H * D + 2 * live * Kv * D)
                           + 4 * B, 4 * live * H * D, "bfloat16")
    rec.setdefault("calls", []).append({
        "call": lab, "ms": res["kernel"]["median"],
        "library_ms": res["sdpa"]["median"], "bound_ms": b_ms,
        "bound_by": b_by})
    print(f"[{label}] {lab}: against the plain version (fp32) on the "
          f"timed inputs: {errs} (tol {ATTN_TOL}); kernel "
          f"{res['kernel']['median']:.4f} ms, "
          f"SDPA {res['sdpa']['median']:.4f} ms (ratio "
          f"{res['kernel']['median'] / res['sdpa']['median']:.3f}), "
          f"bound {b_ms:.4f} ms ({b_by}); card time, in turns")


def _launch_train_runs() -> None:
    """``python -m repro_torch.launch.train`` as a user runs it (no
    ``--device``: the card): ``--smoke --steps 20`` must print a loss at
    step 20 below step 1's and ``done``; ``--arch qwen3-1.7b --steps 5
    --batch 2 --seq 512 --ckpt DIR`` must print ``done`` and write no
    checkpoint (one is saved every 20 steps)."""
    import os
    import shutil
    ck_dir = ROOT / "build" / "chip_smoke_lm_ckpt"
    shutil.rmtree(ck_dir, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for argv in (["--smoke", "--steps", "20"],
                 ["--arch", "qwen3-1.7b", "--steps", "5", "--batch", "2",
                  "--seq", "512", "--ckpt", str(ck_dir)]):
        t0 = time.monotonic()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", *argv],
            capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
        lines = proc.stdout.strip().splitlines()
        need(proc.returncode == 0 and lines and lines[-1] == "done",
             f"launch.train {' '.join(argv)}: rc {proc.returncode}, "
             f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
        steps = {int(ln.split()[1]): float(ln.split()[3]) for ln in lines
                 if ln.startswith("step")}
        if "--smoke" in argv:
            need(steps[20] < steps[1], f"launch.train --smoke: loss at step "
                 f"20 {steps[20]} not below step 1's {steps[1]}")
        else:
            need(not ck_dir.exists() or not any(ck_dir.iterdir()),
                 f"launch.train: a checkpoint before step 20 in {ck_dir}")
        print(f"[train lm] python -m repro_torch.launch.train "
              f"{' '.join(argv)} (no --device): {time.monotonic() - t0:.1f}s"
              f"; {lines[0]}; loss by step "
              f"{json.dumps({k: round(v, 4) for k, v in steps.items()})}; "
              f"{lines[-1]}")
    shutil.rmtree(ck_dir, ignore_errors=True)


def train_lm(records: dict) -> None:
    """LM training on the card at full width:

    1. Qwen3-1.7B (28 layers, d 2048, 16 / 8 heads of 128, d_ff 6144,
       vocab 151,936, untied, bf16, seeded random weights) at
       ``train_4k``'s S = 4096 with the global batch cut to
       LM_TRAIN_BATCH, through ``launch/workloads.build_lm``: step 1
       against a plain twin, then LM_TRAIN_STEPS AdamW steps with 56
       flash launches a step (``_lm_step_vs_plain``);
    2. Qwen2-MoE-A2.7B at every published width, cut to
       MOE_TRAIN_LAYERS of its 24 layers, B 2 x S 1024, one step against
       its plain twin (the sort dispatch and the aux under autograd);
    3. the flash kernel under autograd at the train shape
       (``_flash_train_turns``);
    4. ``prefill_32k`` and ``decode_32k`` (``_lm_serve_32k``);
    5. ``python -m repro_torch.launch.train`` (``_launch_train_runs``)."""
    import torch
    from repro_torch.configs import QWEN2_MOE_A2_7B, QWEN3_1_7B, get_shape
    from repro_torch.launch.workloads import build_lm, build_workload

    t_phase = time.monotonic()
    for cfg, layers, seq, steps in (
            (QWEN3_1_7B, None, None, LM_TRAIN_STEPS),
            (QWEN2_MOE_A2_7B, MOE_TRAIN_LAYERS, MOE_TRAIN_SEQ, 1)):
        full = cfg
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        shape = get_shape(cfg, "train_4k")
        if seq:
            shape = dataclasses.replace(shape, seq_len=seq)
        label = f"train lm {cfg.name}" + (f" ({layers} of {full.n_layers} "
                                          f"layers)" if layers else "")
        gc_collect()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        # the dense model through the entry point a user calls; the MoE
        # model's cut config through build_lm
        wl = build_lm(cfg, shape, device="cuda", seed=0,
                      batch=LM_TRAIN_BATCH) if layers else build_workload(
            cfg.name, shape.name, device="cuda", seed=0,
            batch=LM_TRAIN_BATCH)
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in wl.args[0]["layers"].values()) \
            + sum(t.numel() for n, t in wl.args[0].items() if n != "layers")
        need(n_params == cfg.param_count(), f"{label}: {n_params} params, "
             f"config {cfg.param_count()}")
        reduced = (f"; reduced: n_layers {full.n_layers} -> {layers}, seq "
                   f"{get_shape(full, 'train_4k').seq_len} -> {seq}"
                   if layers else "")
        print(f"[{label}] {cfg.n_layers}L d_model {cfg.d_model} "
              f"{cfg.n_heads}H/{cfg.n_kv_heads}KV head dim {cfg.head_dim}, "
              f"vocab {cfg.vocab_size}, {cfg.dtype}, {n_params:,} params; "
              f"global batch {shape.global_batch} -> {LM_TRAIN_BATCH}"
              f"{reduced}; weights, AdamW state and the first batch built in "
              f"{time.monotonic() - t0:.1f}s, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        res = _lm_step_vs_plain(label, cfg, wl, steps, 2 * cfg.n_layers,
                                records)
        if not layers:
            print(f"[{label}] peak memory {res['peak'] / 2**30:.2f} GiB "
                  f"against the reckoned {LM_PEAK_RECKONED} (params, fp32 "
                  f"master, mu, nu and grads 32.5 GB; the out-of-place "
                  f"update's new state ~28 GB; fp32 temporaries of the "
                  f"largest leaf)")
        del wl, res
    gc_collect()
    _flash_train_turns(records["flash_attention"])
    _lm_serve_32k(records)
    _launch_train_runs()
    print(f"[train lm] phase {time.monotonic() - t_phase:.1f}s")


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
        tier, ivf, build_s = build_static_ivf()
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
            engine = serve_phase(records, ivf, build_s)
            phase = "serve sharded"
            serve_sharded_phase(engine, tier)
            phase = "operability"
            operability_phase(engine, ivf, build_s)
            del engine
            phase = "serve moe"
            serve_moe_phase(records)
            phase = "serve recsys"
            serve_recsys(records)
            phase = "train recsys"
            train_recsys(records)
            phase = "train gnn"
            train_gnn(records)
            phase = "train lm"
            train_lm(records)
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
         **{k: rec[k] for k in ("launches_by_run", "calls", "turns")
            if k in rec}}
        for rec in records.values()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
