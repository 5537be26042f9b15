"""The paper's own serving-path compute as a workload (port of
``repro/launch/cache_workload.py``).

``run`` (the default mode): B concurrent requests' (B, d) queries
against a static tier of S curated fp32 entries, row-sharded over
``shards`` shards of one card: the simsearch kernel a shard (32 queries
a launch) and the k-candidate merge (``index/sharded.
sharded_cosine_topk``). The call is counted on the meta device
(``analysis.counter``), which gives its roofline on one H100; then the
tier and queries are made from a seed on the card and the same call is
timed by CUDA events, the measured time written beside the roofline's
``step_s``:

    PYTHONPATH=src python -m repro_torch.launch.cache_workload

The record lands in ``results/dryrun_torch/krites-cache-lookup__B<B>x
S<S>__card.json``.

``--live``: concurrent clients -> ``CacheRouter`` micro-batcher ->
``KritesPolicy.serve_batch`` (static top-1, masked dynamic top-1,
grey-zone verification) -> a stub backend:

    PYTHONPATH=src python -m repro_torch.launch.cache_workload --live
    PYTHONPATH=src python -m repro_torch.launch.cache_workload --live \\
        --shards 4 --device cpu

``--mesh single|multi|both`` (``run_mesh``; ``run(multi_pod=True)`` is
the reference's name for ``multi``): the same lookup on the
reference's 256- and 512-rank production meshes, counted on meta only,
per rank, under a fake process group (``launch/dryrun.fake_group``):
the tier's rows sharded over 'model' (replicated over the data axes),
each rank's simsearch scan and the all-gather and merge of the (B, k)
candidates (``index/sharded.mesh_cosine_topk``). Records
``krites-cache-lookup__B<B>xS<S>__pod16x16.json`` and
``__pod2x16x16.json``.
"""
from __future__ import annotations

import argparse
import json
import threading
import time
from pathlib import Path

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"
SEED = 0                # the lookup's tier and queries
TIMED_CALLS = 3         # calls timed on the card, after one warm-up


def lookup_inputs(B: int, S: int, d: int, seed: int, device):
    """The lookup's tier (S, d) and queries (B, d): fp32 standard normal
    from a generator on ``device`` seeded by ``seed``, tier first."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    corpus = torch.randn((S, d), generator=gen, device=device)
    return corpus, torch.randn((B, d), generator=gen, device=device)


def run(B: int = 4096, S: int = 4_194_304, d: int = 64, k: int = 4,
        shards: int = 1, device=None, multi_pod: bool = False,
        out_dir: Path = RESULTS) -> dict:
    """4096 in-flight requests against a 4M-entry curated tier: the
    batched exact lookup ``sharded_cosine_topk(q, tier, mesh, k)``.

    1. Counted on meta (nothing allocated): FLOPs (the simsearch
       kernel's, by ``analysis/kernel_costs``), the bytes of its
       arguments, outputs and temporaries, collectives (none on one
       card), and from them the roofline, its compute term at the TF32
       peak: the kernel screens on the tensor cores in TF32 and
       rescores the few screened candidates exactly in fp32.
    2. On ``device`` (default ``cuda``): the tier (S, d) and queries
       (B, d) from ``lookup_inputs(B, S, d, SEED, device)``, one
       warm-up call, then ``TIMED_CALLS`` calls timed by CUDA
       events (``card_ms``, their mean). On the CPU the call runs once
       and nothing is timed.

    Returns the record (also written to ``out_dir``), with the call's
    (B, k) ids under ``"ids"`` (not written) for a caller to check.

    ``multi_pod=True`` counts the lookup on the 512-rank production mesh
    instead (:func:`run_mesh`, the reference's ``multi_pod``); nothing
    runs on ``device``."""
    import torch

    from repro_torch.analysis import roofline as rl
    from repro_torch.analysis.counter import ProgramCounter
    from repro_torch.device import get_device
    from repro_torch.index.sharded import sharded_cosine_topk
    from repro_torch.launch.mesh import make_shard_mesh

    if multi_pod:
        return run_mesh("multi", B, S, d, k, out_dir)
    name = f"krites-cache-lookup:B{B}xS{S}"

    def lookup(q, corpus, mesh):
        return sharded_cosine_topk(q, corpus, mesh, k=k)

    meta_mesh = make_shard_mesh(shards, "meta")
    pc = ProgramCounter()
    pc.run(lambda q, c: lookup(q, c, meta_mesh),
           torch.empty((B, d), device="meta"),
           torch.empty((S, d), device="meta"))
    roof = rl.from_counts(name, pc, 2.0 * B * S * d,
                          compute_dtype="tfloat32")

    dev = get_device(device)
    mesh = make_shard_mesh(shards, dev.type)
    corpus, q = lookup_inputs(B, S, d, SEED, dev)
    _, ids = lookup(q, corpus, mesh)
    card_ms = None
    if dev.type == "cuda":
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(TIMED_CALLS):
            _, ids = lookup(q, corpus, mesh)
        t1.record()
        t1.synchronize()
        card_ms = t0.elapsed_time(t1) / TIMED_CALLS
    rec = {"arch": "krites-cache-lookup", "shape": f"B{B}xS{S}xd{d}",
           "mesh": "card", "shards": shards, "k": k, "ok": True,
           "device": (torch.cuda.get_device_name(dev)
                      if dev.type == "cuda" else str(dev)),
           "memory": rl.memory_summary(pc), "kernels": pc.kernels,
           "collectives": pc.count_collectives(),
           "collective_bytes": pc.collective_bytes(),
           "roofline": roof.to_dict(), "card_ms": card_ms,
           "card_over_bound": (card_ms / (1e3 * roof.step_s)
                               if card_ms is not None else None)}
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"krites-cache-lookup__B{B}xS{S}__card.json").write_text(
        json.dumps(rec, indent=1))
    timed = (f"card {card_ms:.3f} ms (CUDA events, mean of "
             f"{TIMED_CALLS}), "
             f"{rec['card_over_bound']:.2f}x the bound"
             if card_ms is not None else f"ran on {dev}, not timed")
    print(f"[OK] cache-lookup B={B} S={S} d={d} k={k} shards={shards}: "
          f"bound={roof.bound} step={roof.step_s * 1e3:.3f}ms "
          f"compute={roof.compute_s * 1e3:.3f}ms "
          f"memory={roof.memory_s * 1e3:.3f}ms "
          f"coll={roof.collective_s * 1e3:.3f}ms; {timed}")
    rec["ids"] = ids
    return rec


def run_mesh(mesh: str, B: int = 4096, S: int = 4_194_304, d: int = 64,
             k: int = 4, out_dir: Path = RESULTS) -> dict:
    """The lookup counted on rank 0 of the production mesh ``mesh``
    ('single': 16x16, 'multi': 2x16x16) on meta, under a fake process
    group started for the call: per-rank FLOPs (the simsearch kernel's
    on S / 16 rows), bytes, peak and the candidate all-gather; the
    roofline with ``chips`` the mesh size, its compute term at the TF32
    peak. Returns the record (also written to ``out_dir``)."""
    import torch

    from repro_torch.analysis import roofline as rl
    from repro_torch.analysis.counter import ProgramCounter
    from repro_torch.distributed.sharding import (NamedSharding, P,
                                                  distribute)
    from repro_torch.index.sharded import mesh_cosine_topk
    from repro_torch.launch.dryrun import MESH_NAMES, production_mesh

    suffix, chips = MESH_NAMES[mesh]
    name = f"krites-cache-lookup:B{B}xS{S}"
    with production_mesh(mesh) as dm:
        q = distribute(torch.empty((B, d), device="meta"),
                       NamedSharding(dm, P()))
        corpus = distribute(torch.empty((S, d), device="meta"),
                            NamedSharding(dm, P("model", None)))
        pc = ProgramCounter()
        pc.run(lambda q, c: mesh_cosine_topk(q, c, k), q, corpus)
    roof = rl.from_counts(name, pc, 2.0 * B * S * d, chips=chips,
                          compute_dtype="tfloat32")
    rec = {"arch": "krites-cache-lookup", "shape": f"B{B}xS{S}xd{d}",
           "mesh": suffix, "chips": chips, "k": k, "ok": True,
           "device": "meta", "flops": pc.flops(),
           "memory": rl.memory_summary(pc), "kernels": pc.kernels,
           "collectives": pc.count_collectives(),
           "collective_bytes": pc.collective_bytes(),
           "roofline": roof.to_dict()}
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"krites-cache-lookup__B{B}xS{S}__{suffix}.json").write_text(
        json.dumps(rec, indent=1))
    print(f"[OK] cache-lookup {suffix} B={B} S={S} d={d} k={k}: "
          f"bound={roof.bound} step={roof.step_s * 1e3:.4f}ms "
          f"compute={roof.compute_s * 1e3:.4f}ms "
          f"memory={roof.memory_s * 1e3:.4f}ms "
          f"coll={roof.collective_s * 1e3:.4f}ms "
          f"flops/rank={pc.flops():.4g} "
          f"coll_bytes/rank={pc.collective_bytes()['total']}")
    return rec


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
                    help="run the router-fronted live serving demo "
                         "instead of the counted and timed lookup")
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
    ap.add_argument("--batch", type=int, default=4096,
                    help="without --live: in-flight requests B")
    ap.add_argument("--rows", type=int, default=4_194_304,
                    help="without --live: static-tier rows S")
    ap.add_argument("--out", default=str(RESULTS),
                    help="without --live: where the record is written")
    ap.add_argument("--mesh", default="card",
                    choices=["card", "single", "multi", "both"],
                    help="without --live: card (count, then time on the "
                         "card) or the 256- / 512-rank production mesh "
                         "(counted on meta only)")
    a = ap.parse_args(argv)
    if not a.live and a.mesh != "card":
        meshes = ("single", "multi") if a.mesh == "both" else (a.mesh,)
        return [run_mesh(m, B=a.batch, S=a.rows, out_dir=Path(a.out))
                for m in meshes]
    if not a.live:
        return run(B=a.batch, S=a.rows, shards=a.shards, device=a.device,
                   out_dir=Path(a.out))
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
