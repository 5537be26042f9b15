#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py              # every phase; needs one CUDA card
    python3 chip_smoke.py --quick      # build + one check per kernel

Phases, each fatal on failure:

1. device: fail at once without CUDA; print the card's name and power
   limit as ``nvidia-smi`` gives them;
2. build: compile the three CUDA kernels from ``src/repro_torch/csrc``;
3. kernels: hold simsearch, flash attention and decode attention
   against their plain PyTorch versions on the card at the serving
   path's shapes, and time each beside its plain version, a library
   call that computes the same function (used nowhere in the port) and
   the bound computed from the shapes;
4. serve: full-width Qwen3-1.7B with random weights, a 4,194,304-row
   static tier, 128 requests from concurrent clients through
   CacheRouter -> KritesPolicy.serve_batch -> BatchingFrontend ->
   LLMEngine; every kernel's launches are counted over that run, the
   served decisions are checked against the plain static top-1, and the
   model's outputs against the same model with plain attention.

The line before the last is one JSON object with a record per kernel;
the last line is ``{"ok": true, "device": {...}}``. Imports nothing of
JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
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
    from repro_torch.kernels.simsearch import kernel as sk
    return {"simsearch": sk, "flash_attention": fk,
            "decode_attention": dk}


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


# ---------------------------------------------------------------------------
# phase 4: serve
# ---------------------------------------------------------------------------

def serve_phase(records: dict) -> None:
    import numpy as np
    import torch
    from repro_torch.configs import QWEN3_1_7B
    from repro_torch.kernels.simsearch.ref import simsearch_ref
    from repro_torch.launch.serve import build_service, demo_requests, drive

    cfg = QWEN3_1_7B
    t0 = time.monotonic()
    service = build_service(cfg, device="cuda", static_rows=STATIC_ROWS,
                            max_len=512, max_new_tokens=16,
                            router_batch=32, engine_batch=8)
    try:
        n_params = sum(t.numel() for t in service.engine.params["layers"]
                       .values()) + sum(
            t.numel() for k, t in service.engine.params.items()
            if k != "layers")
        print(f"[serve] built in {time.monotonic() - t0:.1f}s: "
              f"{cfg.name} {cfg.n_layers}L d_model {cfg.d_model} "
              f"{cfg.dtype}, {n_params / 1e9:.3f} B params; static tier "
              f"{tuple(service.policy.static.emb.shape)} fp32")
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
        print(f"[serve] {SERVE_REQUESTS} requests in {wall:.2f}s: static "
              f"{rs['static_hit_rate']:.3f} dynamic "
              f"{rs['dynamic_hit_rate']:.3f} backend "
              f"{rs['backend_rate']:.3f}; judged {ps['judged']} approved "
              f"{ps['approved']}; errors {rs['errors']}; p50 "
              f"{rs.get('p50_latency_ms')} ms p99 "
              f"{rs.get('p99_latency_ms')} ms; batches {rs['batches']} "
              f"(mean {rs['mean_batch_size']}); engine batches "
              f"{es.batches} (failed {service.frontend.failed_batches}) "
              f"prefill rows {es.prefills} decode steps {es.decode_steps} generated "
              f"tokens {es.generated_tokens}, engine wall prefill "
              f"{es.wall_prefill_s:.3f}s decode {es.wall_decode_s:.3f}s; "
              f"peak memory {peak / 2**30:.2f} GiB")
        print(f"[serve] kernel launches: {json.dumps(counts)}")
        need(all(r is not None for r in results), "some requests got no "
             "result")
        need(rs["errors"] == 0, f"router errors {rs['errors']}: "
             f"{rs.get('last_error')}")
        need(service.frontend.failed_batches == 0,
             f"{service.frontend.failed_batches} engine batches failed")
        n_backend = sum(r.served_by == "backend" for r in results)
        need(es.prefills == n_backend, f"engine prefilled {es.prefills} "
             f"rows, the backend served {n_backend}")
        need(all(c > 0 for c in counts.values()),
             f"a kernel of the path never launched: {counts}")
        # a router batch holds at most 32 rows: one simsearch launch each
        need(counts["simsearch"] == rs["batches"],
             f"simsearch launches {counts['simsearch']} != batches "
             f"{rs['batches']}")
        need(counts["flash_attention"] == cfg.n_layers * es.batches,
             f"flash launches {counts['flash_attention']} != layers x "
             f"prefills {cfg.n_layers * es.batches}")
        need(counts["decode_attention"] == cfg.n_layers * es.decode_steps,
             f"decode launches {counts['decode_attention']} != layers x "
             f"decode steps {cfg.n_layers * es.decode_steps}")
        for rec in records.values():
            rec["launches"] = counts[rec["name"]]

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
            # a miss against an empty dynamic tier scores -inf
            need(math.isfinite(r.similarity) or r.served_by == "backend"
                 and r.similarity == -math.inf, f"row {i}: similarity "
                 f"{r.similarity}")
            # generated text may be empty: a random-weight model mostly
            # emits ids outside the byte tokenizer's range
            need(isinstance(r.answer, str), f"row {i}: answer {r.answer!r}")
            if r.served_by == "static":
                need(r.answer.startswith("[curated] "),
                     f"row {i}: static answer {r.answer!r}")
                need(abs(r.similarity - ref_s[i]) <= SCORE_TOL,
                     f"row {i}: served {r.similarity} vs plain "
                     f"{ref_s[i]}")
        print(f"[serve] decisions agree with the plain static top-1 on "
              f"all {len(results)} rows")
        check_model(service.engine)
    finally:
        service.stop()


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
        print(f"[build] 3 kernels, one nvcc for sm_90a: "
              f"{time.monotonic() - t0:.1f}s")

        phase = "kernels"
        records = {}
        for check in (check_simsearch, check_flash, check_decode):
            rec = check(args.quick)
            records[rec["name"]] = rec
            torch.cuda.synchronize()
            if not args.quick:
                print(f"[kernels] {rec['name']}: {rec['ms']:.4f} ms, plain "
                      f"{rec['plain_ms']:.4f} ms, library "
                      f"{rec['library_ms']:.4f} ms, bound "
                      f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})")

        if not args.quick:
            phase = "serve"
            serve_phase(records)
        torch.cuda.synchronize()
    except Exception as e:  # noqa: BLE001 — report the phase, then fail
        print(f"chip_smoke: phase {phase} FAILED: {e!r}", file=sys.stderr)
        raise
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: rec.get(k) for k in keys}
                                  for rec in records.values()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
