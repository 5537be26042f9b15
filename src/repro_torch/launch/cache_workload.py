"""The live cache workload: concurrent clients -> ``CacheRouter``
micro-batcher -> ``KritesPolicy.serve_batch`` (static top-1, masked
dynamic top-1, grey-zone verification) -> a stub backend (port of
``repro/launch/cache_workload.py``, its ``--live`` mode):

    PYTHONPATH=src python -m repro_torch.launch.cache_workload --live
    PYTHONPATH=src python -m repro_torch.launch.cache_workload --live \\
        --shards 4 --device cpu

The reference's default mode (``run``) lowers the sharded lookup
against a 256-chip XLA mesh and reads its HLO and roofline: XLA tooling,
which the port takes up last (ROADMAP.md queue 4, "XLA-specific
tooling"). Without ``--live`` this command says so and exits.
"""
from __future__ import annotations

import argparse
import threading
import time


def run_live(n_requests: int = 800, n_clients: int = 8,
             max_batch: int = 32, max_wait_ms: float = 2.0,
             tau: float = 0.92, index: str = "flat",
             static_rows: int = 0, nprobe: int = 8,
             dyn_index: str = "flat", seg_rows: int = 4096,
             compact_every: int = 4, shards: int = 1,
             l1_capacity: int = 0, volatile_bypass: bool = False,
             ttl_volatile: int = 0, ttl_stable: int = 0,
             adaptive: bool = False, adapt_every: int = 256,
             adapt_window: int = 1024, rewrite: bool = False,
             rewrite_rate: float = 1.0, device=None) -> dict:
    """Router-fronted serving under concurrent client load, on
    ``device`` (default ``cuda``), with per-tier hit and latency
    telemetry; returns the router's stats with ``requests_per_s``.
    ``index='ivf'`` serves the static tier through the IVF index (pad
    it to ``static_rows`` synthetic rows first), ``dyn_index=
    'segmented'`` the dynamic tier through the segmented index, and
    ``shards`` > 1 both tiers row-sharded over that many shards
    (``launch/mesh.make_shard_mesh``) with shard-routed writes:
    decisions identical to one device, and the segmented index replaced
    by the sharded masked scan."""
    import numpy as np

    from repro_torch.launch.serve import build_service

    freshness = None
    if volatile_bypass or ttl_volatile or ttl_stable:
        from repro_torch.core.freshness import FreshnessPolicy
        freshness = FreshnessPolicy(volatile_bypass=volatile_bypass,
                                    ttl_volatile=ttl_volatile,
                                    ttl_stable=ttl_stable,
                                    ttl_unknown=ttl_stable)
    params = None
    if adaptive:
        from repro_torch.core.adaptive import AdaptiveParams
        params = AdaptiveParams(window=adapt_window, adapt_every=adapt_every)
    intents = [f"how do i {v} my {n}" for v in
               ("fix", "update", "reset", "clean", "sell", "charge")
               for n in ("bike", "laptop", "router", "garden", "phone")]
    service = build_service(
        None, device=device, tau=tau, capacity=1024,
        static_rows=static_rows, router_batch=max_batch,
        router_wait_ms=max_wait_ms, index=index, nprobe=nprobe,
        dyn_index=dyn_index, seg_rows=seg_rows,
        compact_every=compact_every, l1_capacity=l1_capacity,
        freshness=freshness, rewrite=rewrite, rewrite_rate=rewrite_rate,
        adaptive=params, shards=shards, intents=intents)
    policy, router = service.policy, service.router

    prefixes = ["", "hey ", "um, ", "please, ", "quick q: ", "so, "]
    rng = np.random.default_rng(0)
    reqs = [(prefixes[int(rng.integers(len(prefixes)))] + intents[c], c)
            for c in rng.integers(0, len(intents), n_requests)]

    def client(k):
        for p, c in reqs[k::n_clients]:
            router.submit(p, meta={"cls": int(c)})

    try:
        t0 = time.time()
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(n_clients)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall = time.time() - t0     # serving throughput only: the async
        policy.pool.drain()         # verification drain is off the path
        s = router.stats()
    finally:
        service.stop()
    s["requests_per_s"] = round(n_requests / wall, 1)
    print(f"[OK] live router: {n_requests} reqs from {n_clients} clients "
          f"in {wall:.2f}s ({s['requests_per_s']} req/s)")
    for k, v in s.items():
        print(f"  {k:22s} {v}")
    return s


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--live", action="store_true",
                    help="run the router-fronted live serving demo (the "
                         "only mode of the port)")
    ap.add_argument("--requests", type=int, default=800)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--index", choices=["flat", "ivf"], default="flat",
                    help="static-tier lookup: exact flat scan or the IVF "
                         "index")
    ap.add_argument("--static-rows", type=int, default=0,
                    help="pad the curated tier to this many rows before "
                         "building the index")
    ap.add_argument("--nprobe", type=int, default=8)
    ap.add_argument("--dyn-index", choices=["flat", "segmented"],
                    default="flat",
                    help="dynamic-tier lookup: exact masked scan or the "
                         "segmented index")
    ap.add_argument("--seg-rows", type=int, default=4096,
                    help="segmented index: tail rows per sealed segment")
    ap.add_argument("--compact-every", type=int, default=4,
                    help="segmented index: merge after this many seals")
    ap.add_argument("--shards", type=int, default=1,
                    help="serve both tiers row-sharded over this many "
                         "shards; 1 = the single-device path")
    ap.add_argument("--l1-capacity", type=int, default=0,
                    help="L1 exact-match front tier size; 0 = off")
    ap.add_argument("--volatile-bypass", action="store_true",
                    help="serve freshness-volatile prompts cache-free")
    ap.add_argument("--ttl-volatile", type=int, default=0,
                    help="entry lifetime of volatile content (ticks; 0 = "
                         "never expires)")
    ap.add_argument("--ttl-stable", type=int, default=0,
                    help="entry lifetime of stable/unknown content "
                         "(ticks; 0 = never expires)")
    ap.add_argument("--adaptive", action="store_true",
                    help="online per-segment threshold controller")
    ap.add_argument("--adapt-every", type=int, default=256,
                    help="recorded requests between shadow sweeps")
    ap.add_argument("--adapt-window", type=int, default=1024,
                    help="controller request-window ring size")
    ap.add_argument("--rewrite", action="store_true",
                    help="REWRITE verdicts for would-be rejects in the "
                         "grey zone, promoted keyed to the new prompt")
    ap.add_argument("--rewrite-rate", type=float, default=1.0,
                    help="rewrite token-bucket refill per judged task")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    a = ap.parse_args(argv)
    if not a.live:
        ap.error("the dry-run lowering against a 256-chip XLA mesh is XLA "
                 "tooling, not ported (ROADMAP.md queue 4, "
                 "\"XLA-specific tooling\"); pass --live")
    return run_live(n_requests=a.requests, n_clients=a.clients,
                    max_batch=a.max_batch, index=a.index,
                    static_rows=a.static_rows, nprobe=a.nprobe,
                    dyn_index=a.dyn_index, seg_rows=a.seg_rows,
                    compact_every=a.compact_every, shards=a.shards,
                    l1_capacity=a.l1_capacity,
                    volatile_bypass=a.volatile_bypass,
                    ttl_volatile=a.ttl_volatile, ttl_stable=a.ttl_stable,
                    adaptive=a.adaptive, adapt_every=a.adapt_every,
                    adapt_window=a.adapt_window, rewrite=a.rewrite,
                    rewrite_rate=a.rewrite_rate, device=a.device)


if __name__ == "__main__":
    main()
