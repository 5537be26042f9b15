"""Quickstart: reproduce the paper's Table 1 on a reduced synthetic trace,
then serve through the IVF ANN index at production tier size (the
PyTorch twin of ``examples/quickstart.py``).

Part 1 runs the GPTCache-style baseline (Alg. 1) and Krites (Alg. 2)
over the same request stream / static tier / thresholds on the
simulator and prints the static-origin served fraction for both, the
paper's headline metric.

Part 2 scales the static tier to 131,072 rows, builds the IVF quantized
index over it and serves the same prompts through a policy with
``index=`` injected (the IVF band scan kernel on the card), beside the
exact flat scan (the simsearch kernel), with the decision agreement.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch.core.policy import BaselinePolicy
from repro_torch.core.simulate import simulate, summarize
from repro_torch.core.tiers import CacheConfig, make_static_tier
from repro_torch.data.synth_traces import LMARENA_LIKE, build_benchmark
from repro_torch.device import get_device
from repro_torch.index.ivf import IVFIndex, build_ivf

BATCH = 64


def table1(device, n_requests: int, n_classes: int) -> tuple:
    """Part 1: baseline and Krites on the simulator; returns their
    summaries."""
    # a laptop-sized slice of the conversational workload
    spec = dataclasses.replace(LMARENA_LIKE, n_requests=n_requests,
                               n_classes=n_classes)
    bench = build_benchmark(spec)
    print(f"workload={spec.name}  static tier={len(bench.static_cls)} "
          f"curated answers  eval stream={len(bench.eval_cls)} requests")

    cfg = CacheConfig(tau_static=0.88, tau_dynamic=0.88, sigma_min=0.0,
                      capacity=4096, judge_latency=64)
    args = dict(static_emb=bench.static_emb, static_cls=bench.static_cls,
                q_emb=bench.eval_emb, q_cls=bench.eval_cls, cfg=cfg,
                device=device)

    rows = []
    for name, krites in (("baseline (Alg.1)", False),
                         ("Krites (Alg.2)", True)):
        t0 = time.time()
        res = summarize(simulate(krites=krites, **args))
        rows.append(res)
        print(f"\n{name}  [{time.time()-t0:.1f}s]")
        for k in ("static_hit_rate", "promoted_hit_rate",
                  "static_origin_rate", "total_hit_rate", "error_rate",
                  "judge_calls", "promotions"):
            print(f"  {k:22s} {res[k]}")

    b, k = rows
    gain = k["static_origin_rate"] / max(b["static_origin_rate"], 1e-9) - 1
    print(f"\nstatic-origin served fraction: {b['static_origin_rate']:.3f}"
          f" -> {k['static_origin_rate']:.3f}  (+{100*gain:.0f}%)")
    print(f"total hit rate unchanged: {b['total_hit_rate']:.3f} vs "
          f"{k['total_hit_rate']:.3f}; error {b['error_rate']:.4f} vs "
          f"{k['error_rate']:.4f}")
    return b, k


def ivf_serving(device, S: int, n_req: int) -> dict:
    """Part 2: the same prompts through the flat scan and the IVF index
    over an S-row static tier; returns the agreement and timings."""
    d = 64
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(S // 256, d)).astype(np.float32)
    tier_emb = centers[rng.integers(0, len(centers), S)] \
        + 0.35 * rng.normal(size=(S, d)).astype(np.float32)
    tier = make_static_tier(tier_emb, np.arange(S) % 1000, device=device)
    answers = [f"curated-{i}" for i in range(S)]

    print(f"\nbuilding IVF index over a {S}-row static tier ...")
    t0 = time.time()
    index = IVFIndex(build_ivf(tier.emb, corpus_normalized=True), nprobe=16)
    print(f"  {index.describe()}  [{time.time()-t0:.1f}s]")

    # prompts embed to noisy copies of tier rows: the cache-hit workload
    # (0.04 noise in 64d ~ 0.95 cosine to the source row, above tau=0.9)
    src = rng.choice(S, n_req, replace=False)
    emb = {f"p{i}": tier_emb[src[i]]
           + 0.04 * rng.normal(size=d).astype(np.float32)
           for i in range(n_req)}
    prompts = list(emb)

    def mk(idx):
        return BaselinePolicy(
            CacheConfig(tau_static=0.9, tau_dynamic=0.9, capacity=1024),
            tier, answers, embed_fn=emb.get,
            backend_fn=lambda p: f"gen({p})", d=d, index=idx,
            device=device)

    flat_pol, ivf_pol = mk(None), mk(index)

    def run_batches(pol):
        t0 = time.time()
        out = []
        for i in range(0, n_req, BATCH):
            out += pol.serve_batch(prompts[i:i + BATCH])
        return out, time.time() - t0

    run_batches(mk(None))          # warm both paths up
    run_batches(mk(index))
    flat_res, flat_s = run_batches(flat_pol)
    ivf_res, ivf_s = run_batches(ivf_pol)

    agree = sum(a.served_by == b.served_by and a.answer == b.answer
                for a, b in zip(flat_res, ivf_res)) / n_req
    print(f"served {n_req} requests: flat {1e3*flat_s/n_req:.1f} ms/req, "
          f"ivf {1e3*ivf_s/n_req:.1f} ms/req "
          f"({flat_s/ivf_s:.1f}x), decision agreement {agree:.3f}")
    return {"agreement": agree, "flat_s": flat_s, "ivf_s": ivf_s}


def main(argv=None, *, n_requests: int = 20_000, n_classes: int = 3_000,
         tier_rows: int = 131_072, n_queries: int = 256) -> dict:
    """Both parts at the reference's sizes (smaller ones for a test);
    returns {"baseline", "krites", "agreement", "flat_s", "ivf_s"}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = get_device(args.device)
    b, k = table1(device, n_requests, n_classes)
    return {"baseline": b, "krites": k,
            **ivf_serving(device, tier_rows, n_queries)}


if __name__ == "__main__":
    main()
