"""Serving launcher: Krites-fronted LLM engine with request batching
(port of ``repro/launch/serve.py``, batched path).

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 200
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --index ivf \
        --static-rows 100000 --dyn-index segmented
    PYTHONPATH=src python -m repro_torch.launch.serve --fused
    PYTHONPATH=src python -m repro_torch.launch.serve --shards 4
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b
    PYTHONPATH=src python -m repro_torch.launch.serve --l1-capacity 256 \
        --volatile-bypass --ttl-stable 4096 --rewrite --adaptive \
        --snapshot-dir /var/lib/krites

``--index ivf`` serves the static tier through the IVF index
(``kernels/ivf_scan`` + exact rerank), ``--dyn-index segmented`` the
dynamic tier through a ``SegmentedIndex`` (a ``--seg-rows`` tail sealed
into int8 segments, merged every ``--compact-every`` seals), and
``--fused`` both lookups through one ``kernels/fused_serve`` dispatch;
``--fused`` excludes the other two. ``--shards N`` serves both tiers
row-sharded over ``N`` shards (``launch/mesh.make_shard_mesh``: shard
``s`` on card ``s % device_count()``, or every shard on the CPU with
``--device cpu``): a simsearch scan a shard (or, with ``--index ivf``,
a ``ShardedIVFIndex``) and a candidate merge, writes routed to the
owning shard, decisions identical to ``--shards 1``. With ``--dyn-index
segmented`` it notes the conflict and serves the row-sharded masked
scan; ``--fused`` refuses it.

The service flags are the JAX launcher's: ``--l1-capacity`` (exact-match
front), ``--volatile-bypass`` / ``--ttl-volatile`` / ``--ttl-stable``
(freshness), ``--rewrite`` / ``--rewrite-rate`` (REWRITE verdicts with
the template rewriter), ``--adaptive`` / ``--adapt-every`` /
``--adapt-window`` / ``--adapt-frozen`` (online thresholds), and
``--snapshot-dir`` / ``--wal`` / ``--wal-fsync-every`` /
``--snapshot-every`` (crash safety). With ``--snapshot-dir`` the
launcher restores the newest snapshot on start (its IVF layout
warm-loaded when it matches the static tier, a cold build only when it
does not), opens the promotion WAL (default ``<dir>/promo.wal``),
replays its tail past the snapshot's cursor, and snapshots and compacts
the WAL at shutdown. ``--serve-stdio`` runs a JSON-lines service on
stdin/stdout instead of the demo drive (ops ``serve``, ``stats``,
``snapshot``, ``drain``, ``shutdown``).

Wires embedder -> KritesPolicy (tiered cache + async judge pool) ->
BatchingFrontend -> LLMEngine, and drives it through ``CacheRouter``:
concurrent clients submit requests, the router coalesces them into
micro-batches for ``KritesPolicy.serve_batch``, whose misses reach the
engine as one ``BatchingFrontend.submit_many`` group. The LM config is
an argument of :func:`build_service`; the command line keeps the JAX
launcher's ``smoke_config`` of ``--arch`` (dense or MoE:
``qwen2-moe-a2.7b``, ``llama4-scout-17b-a16e``), with the head dim of
the card's attention kernels on CUDA (``smoke_config_for``). Runs on
``cuda`` unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import queue
import sys
import threading
import time
from dataclasses import dataclass

import numpy as np

DEMO_INTENTS = [f"how do i {v} my {n}" for v in
                ("fix", "update", "reset", "clean", "sell")
                for n in ("bike", "laptop", "router", "garden")]
DEMO_PREFIXES = ["", "hey ", "um, ", "please, ", "quick q: "]


def build_demo_tier(emb_rows, answers, static_rows: int = 0,
                    index: str = "flat", nprobe: int = 8, texts=None,
                    device=None, ivf=None, mesh=None):
    """Pad the curated tier with synthetic entries to ``static_rows``
    rows (random directions from ``np.random.default_rng(7)``, each its
    own answer class, as in the JAX launcher), build the static tier on
    ``device`` and, for ``index="ivf"``, its ``IVFIndex``, or with a
    ``mesh`` its ``ShardedIVFIndex`` (over ``ivf``, a layout already
    built for this tier, or under a mesh one layout a shard, when
    given). With a ``mesh`` the tier's rows are its per-shard blocks
    (``index/sharded.shard_static_rows``); a mesh over several devices
    builds them on the host first, so that no card holds the whole
    tier. Returns (StaticTier, answers, texts, index object or None for
    exact flat)."""
    from repro_torch.core.tiers import make_static_tier

    emb_rows = np.asarray(emb_rows, np.float32)
    answers = list(answers)
    texts = list(texts) if texts is not None else [str(a) for a in answers]
    if static_rows > len(answers):
        pad = np.random.default_rng(7).normal(
            size=(static_rows - len(answers),
                  emb_rows.shape[1])).astype(np.float32)
        emb_rows = np.concatenate([emb_rows, pad])
        answers += [f"[curated] synthetic-{i}" for i in range(len(pad))]
        texts += [f"synthetic prompt {i}" for i in range(len(pad))]
    spread = mesh is not None and len(set(mesh.devices)) > 1
    tier = make_static_tier(emb_rows, np.arange(len(answers)),
                            device="cpu" if spread else device)
    if mesh is not None:
        from repro_torch.index.sharded import shard_static_rows
        dev0 = mesh.devices[0]
        tier = dataclasses.replace(
            tier, emb=shard_static_rows(tier.emb, mesh),
            cls=tier.cls.to(dev0), answer_ref=tier.answer_ref.to(dev0))
    idx_obj = None
    if index == "ivf" and mesh is not None:
        from repro_torch.index.sharded import ShardedIVFIndex
        idx_obj = ShardedIVFIndex(tier.emb, mesh, nprobe=nprobe, sivf=ivf,
                                  corpus_normalized=True)
        print(f"static index: {idx_obj.describe()}")
    elif index == "ivf":
        from repro_torch.index.ivf import IVFIndex, build_ivf
        idx_obj = IVFIndex(ivf if ivf is not None else
                           build_ivf(tier.emb, corpus_normalized=True),
                           nprobe=nprobe)
        print(f"static index: {idx_obj.describe()}")
    return tier, answers, texts, idx_obj


def build_dyn_index(dyn_index: str, capacity: int, d: int,
                    seg_rows: int = 4096, compact_every: int = 4,
                    device=None):
    """Dynamic-tier lookup for the launcher: 'flat' -> None (the exact
    masked scan), 'segmented' -> a ``SegmentedIndex`` whose
    ``seg_rows`` tail seals into int8 segments, merged every
    ``compact_every`` seals."""
    if dyn_index != "segmented":
        return None
    from repro_torch.index.segmented import SegmentedIndex
    idx = SegmentedIndex(capacity, d, tail_rows=seg_rows,
                         compact_every=compact_every, device=device)
    print(f"dynamic index: {idx.describe()}")
    return idx


def _stub_backend(prompt: str) -> str:
    return f"generated({prompt})"


def _stub_backend_batch(prompts) -> list:
    return [_stub_backend(p) for p in prompts]


@dataclass
class Service:
    """The wired serving stack (``frontend`` and ``engine`` None behind
    the stub backend); ``stop()`` ends every thread it runs."""
    policy: object
    router: object
    frontend: object
    engine: object

    def stop(self) -> None:
        self.router.stop()
        self.policy.pool.stop()
        if self.frontend is not None:
            self.frontend.stop()


def build_service(lm_cfg, *, device=None, tau: float = 0.92,
                  capacity: int = 512, static_rows: int = 0,
                  max_len: int = 96, max_new_tokens: int = 8,
                  router_batch: int = 32, engine_batch: int = 8,
                  params=None, seed: int = 0, index: str = "flat",
                  nprobe: int = 8, dyn_index: str = "flat",
                  seg_rows: int = 4096, compact_every: int = 4,
                  fused: bool = False, ivf=None, engine=None,
                  l1_capacity: int = 0, freshness=None,
                  rewrite: bool = False, rewrite_rate: float = 1.0,
                  wal=None, adaptive=None, adapt_frozen: bool = False,
                  snapshot=None, shards: int = 1,
                  intents=DEMO_INTENTS,
                  router_wait_ms: float = 2.0) -> Service:
    """Embedder -> KritesPolicy -> BatchingFrontend -> LLMEngine behind a
    CacheRouter, for the LM config ``lm_cfg`` on ``device`` (default
    ``cuda``). ``index``/``nprobe``, ``dyn_index``/``seg_rows``/
    ``compact_every`` and ``fused`` pick the lookup paths as the
    launcher's flags do; ``ivf`` is an IVF layout already built over
    this static tier (it skips the build), and ``engine`` an
    ``LLMEngine`` to serve with instead of building one (its weights
    then take the place of ``params``/``seed``). With neither ``lm_cfg``
    nor ``engine`` there is no engine: the backend is a stub that
    answers ``generated(<prompt>)``. ``intents`` are the curated
    prompts of the static tier, ``router_batch`` / ``router_wait_ms``
    the router's micro-batch bounds. ``shards`` > 1 serves
    both tiers row-sharded over ``launch/mesh.make_shard_mesh(shards,
    device)`` (``ivf`` then holds one layout a shard); a segmented
    ``dyn_index`` is then noted and replaced by the sharded masked scan.

    The service options: ``l1_capacity`` (0 = no L1 front),
    ``freshness`` (a ``FreshnessPolicy``, also the judge's TTL source),
    ``rewrite``/``rewrite_rate`` (REWRITE verdicts for every would-be
    reject, resolved by the template rewriter), ``wal`` (a
    ``PromotionWAL``), ``adaptive`` (``AdaptiveParams``; the controller
    is frozen with ``adapt_frozen``) and ``snapshot`` (a loaded
    ``persist.Snapshot``: with ``index="ivf"`` and no ``ivf`` its layout
    is warm-loaded when it matches the tier, else built cold). The
    snapshot's state itself is installed by ``persist.restore_policy``,
    which the caller runs."""
    if fused and (index != "flat" or dyn_index != "flat" or shards > 1):
        raise ValueError("fused replaces both tier lookups; it cannot be "
                         "combined with index='ivf', "
                         "dyn_index='segmented' or shards > 1")
    from repro_torch.core.judge import OracleJudge, template_rewriter
    from repro_torch.core.policy import KritesPolicy
    from repro_torch.core.tiers import CacheConfig
    from repro_torch.device import get_device
    from repro_torch.embedding.embedder import Embedder
    from repro_torch.serving.engine import BatchingFrontend, LLMEngine
    from repro_torch.serving.router import CacheRouter

    dev = get_device(device)
    mesh = None
    if shards > 1:
        from repro_torch.launch.mesh import make_shard_mesh
        mesh = make_shard_mesh(shards, device=device)
        print(f"shards: {shards} on "
              f"{', '.join(str(d) for d in mesh.devices)}")
        if dyn_index == "segmented":
            print("note: the segmented dynamic index is single-device "
                  "only; the shards serve the dynamic tier through the "
                  "row-sharded masked scan")
            dyn_index = "flat"
    embed = Embedder(d_out=64, device=dev)
    if engine is None and lm_cfg is not None:
        engine = LLMEngine(lm_cfg, params=params, seed=seed,
                           max_len=max_len, device=dev)
    if engine is None:
        frontend = None
        backend_fn = _stub_backend
        backend_batch_fn = _stub_backend_batch
    else:
        frontend = BatchingFrontend(engine, max_batch=engine_batch,
                                    max_new_tokens=max_new_tokens)
        backend_fn = frontend.submit
        backend_batch_fn = frontend.submit_many
    canon = list(intents)
    warm = snapshot is not None and index == "ivf" and ivf is None \
        and mesh is None
    tier, answers, texts, static_index = build_demo_tier(
        embed.batch(canon), [f"[curated] {p}" for p in canon],
        static_rows=static_rows, index="flat" if warm else index,
        nprobe=nprobe, texts=canon, device=dev, ivf=ivf, mesh=mesh)
    if warm:
        from repro_torch.serving import persist
        static_index = persist.load_static_index(snapshot, tier.emb,
                                                 nprobe=nprobe)
        if static_index is not None:
            print(f"static index: warm-restored {static_index.describe()}")
        else:
            from repro_torch.index.ivf import IVFIndex, build_ivf
            static_index = IVFIndex(build_ivf(tier.emb,
                                              corpus_normalized=True),
                                    nprobe=nprobe)
            print(f"static index: {static_index.describe()} (snapshot "
                  "index stale or absent: cold build)")
    fused_obj = None
    if fused:
        from repro_torch.index.ivf import build_ivf
        from repro_torch.kernels.fused_serve import FusedServe
        fused_obj = FusedServe(ivf if ivf is not None else
                               build_ivf(tier.emb, corpus_normalized=True),
                               nprobe=nprobe)
        print(f"serve path: {fused_obj.describe()}")
    cfg = CacheConfig(
        tau, tau, sigma_min=0.3, capacity=capacity, l1=bool(l1_capacity),
        volatile_bypass=bool(freshness and freshness.volatile_bypass),
        ttl_volatile=freshness.ttl_volatile if freshness else 0,
        ttl_stable=freshness.ttl_stable if freshness else 0,
        rewrite=rewrite, rewrite_rate=rewrite_rate)
    controller = None
    if adaptive is not None:
        from repro_torch.core.adaptive import AdaptiveController
        controller = AdaptiveController(cfg, d=64, params=adaptive,
                                        frozen=adapt_frozen)
    # the demo's oracle rewrite model: every would-be reject in the grey
    # zone is tailorable by the deterministic template rewriter
    judge = OracleJudge(freshness=freshness,
                        rewritable=(lambda qc, hc, qt, ht: True)
                        if rewrite else None)
    policy = KritesPolicy(cfg, tier, answers, embed,
                          backend_fn=backend_fn, judge_fn=judge, d=64,
                          backend_batch_fn=backend_batch_fn,
                          static_texts=texts, index=static_index,
                          dyn_index=build_dyn_index(
                              dyn_index, capacity, 64, seg_rows,
                              compact_every, device=dev),
                          fused=fused_obj, wal=wal,
                          rewriter=template_rewriter if rewrite else None,
                          l1=l1_capacity or None, freshness=freshness,
                          adaptive=controller, mesh=mesh, device=dev)
    router = CacheRouter(policy, max_batch=router_batch,
                         max_wait_ms=router_wait_ms)
    return Service(policy, router, frontend, engine)


def demo_requests(n: int, seed: int = 0):
    """``n`` (prompt, meta) pairs: a demo intent with a random prefix,
    its class in ``meta``, as the JAX demo loop draws them."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        c = int(rng.integers(0, len(DEMO_INTENTS)))
        p = DEMO_PREFIXES[int(rng.integers(0, len(DEMO_PREFIXES)))] \
            + DEMO_INTENTS[c]
        out.append((p, {"cls": c}))
    return out


def drive(service: Service, requests, n_clients: int = 8,
          timeout_s: float = 600.0):
    """Serve ``requests`` from ``n_clients`` concurrent client threads
    through the router; returns the ServeResults in request order (None
    where a batch failed)."""
    results = [None] * len(requests)

    def client(c: int) -> None:
        for i in range(c, len(requests), n_clients):
            p, meta = requests[i]
            results[i] = service.router.submit(p, meta, timeout_s=timeout_s)

    threads = [threading.Thread(target=client, args=(c,), daemon=True,
                                name=f"client-{c}")
               for c in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout_s)
        if t.is_alive():
            raise TimeoutError(f"{t.name} still waiting after {timeout_s}s")
    return results


def _serve_stdio(policy, snap_dir, wal, stdin=None, stdout=None) -> None:
    """JSON-lines service loop: one message per input line, one JSON
    reply per line. Messages are processed in arrival order; consecutive
    ``serve`` ops already queued are coalesced into one ``serve_batch``
    call. Control ops: ``stats``, ``snapshot``, ``drain``,
    ``shutdown``; end of input ends the loop too."""
    from repro_torch.distributed import checkpoint as ckpt
    from repro_torch.serving import persist

    stdin = sys.stdin if stdin is None else stdin
    stdout = sys.stdout if stdout is None else stdout
    inq: "queue.Queue[object]" = queue.Queue()

    def _reader():
        for line in stdin:
            line = line.strip()
            if line:
                inq.put(line)
        inq.put(None)

    reader = threading.Thread(target=_reader, daemon=True,
                              name="stdio-reader")
    reader.start()

    def emit(obj: dict) -> None:
        stdout.write(json.dumps(obj) + "\n")
        stdout.flush()

    def _serve_run(msgs: list) -> None:
        results = policy.serve_batch(
            [m.get("prompt", "") for m in msgs],
            [{"cls": m["cls"]} if "cls" in m else None for m in msgs])
        for m, r in zip(msgs, results):
            emit({"ok": True, "id": m.get("id"),
                  "served_by": r.served_by,
                  "static_origin": bool(r.static_origin),
                  "similarity": float(r.similarity),
                  "stale": bool(r.meta.get("stale", False)),
                  "bypass": r.meta.get("bypass"),
                  "answer": None if r.answer is None else str(r.answer)})

    emit({"ok": True, "ready": True, "pid": os.getpid(), "t": policy.t,
          "wal_seq": wal.seq if wal is not None else None})
    eof = False
    while not eof:
        first = inq.get()
        if first is None:
            break
        batch = [first]
        while True:          # coalesce whatever has already arrived
            try:
                nxt = inq.get_nowait()
            except queue.Empty:
                break
            if nxt is None:
                eof = True
                break
            batch.append(nxt)

        msgs = []
        for ln in batch:
            try:
                msgs.append(json.loads(ln))
            except ValueError:
                emit({"ok": False, "error": f"bad json: {ln[:80]!r}"})
        i = 0
        while i < len(msgs):
            msg = msgs[i]
            op = msg.get("op", "serve")
            if op == "serve":
                j = i
                while j < len(msgs) and \
                        msgs[j].get("op", "serve") == "serve":
                    j += 1
                _serve_run(msgs[i:j])
                i = j
                continue
            if op == "stats":
                s = policy.stats()
                s["t"] = policy.t
                depth = policy.pool.depth()
                s["judge_queued"] = depth["queued"]
                s["judge_inflight"] = depth["inflight"]
                emit({"ok": True, "id": msg.get("id"), "stats": s})
            elif op == "snapshot":
                if snap_dir is None:
                    emit({"ok": False, "id": msg.get("id"),
                          "error": "no --snapshot-dir"})
                else:
                    path = persist.save_snapshot(snap_dir, policy)
                    ckpt.prune(snap_dir, keep=3)
                    emit({"ok": True, "id": msg.get("id"),
                          "snapshot": str(path), "t": policy.t,
                          "wal_seq": wal.seq if wal is not None else None})
            elif op == "drain":
                policy.pool.drain(float(msg.get("timeout_s", 30.0)))
                emit({"ok": True, "id": msg.get("id"),
                      "depth": policy.pool.depth()})
            elif op == "shutdown":
                emit({"ok": True, "id": msg.get("id"), "bye": True})
                eof = True
                break
            else:
                emit({"ok": False, "id": msg.get("id"),
                      "error": f"unknown op {op!r}"})
            i += 1
    # the reader ends at end of input; after a shutdown op it may still
    # wait on an open input, which the daemon flag lets the process leave
    reader.join(0.1)


def main(argv=None) -> dict:
    """Serve ``--requests`` demo requests (or, with ``--serve-stdio``,
    the JSON-lines service); print and return the final policy and
    router stats, with ``restored_step`` / ``restored_t`` /
    ``restored_dyn_live`` and ``wal_replayed`` / ``wal_skipped`` when a
    snapshot or a WAL was recovered."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--tau", type=float, default=0.92)
    ap.add_argument("--capacity", type=int, default=512,
                    help="dynamic-tier capacity")
    ap.add_argument("--static-rows", type=int, default=0,
                    help="pad the curated tier to this many rows with "
                         "synthetic entries")
    ap.add_argument("--index", default="flat", choices=["flat", "ivf"],
                    help="static-tier lookup: exact flat scan or the IVF "
                         "index")
    ap.add_argument("--nprobe", type=int, default=8,
                    help="IVF clusters probed per query")
    ap.add_argument("--dyn-index", default="flat",
                    choices=["flat", "segmented"],
                    help="dynamic-tier lookup: exact masked scan or the "
                         "segmented index")
    ap.add_argument("--seg-rows", type=int, default=4096,
                    help="segmented index: tail rows per sealed segment")
    ap.add_argument("--compact-every", type=int, default=4,
                    help="segmented index: merge after this many seals")
    ap.add_argument("--fused", action="store_true",
                    help="both tier lookups in one fused dispatch "
                         "(excludes --index ivf, --dyn-index segmented "
                         "and --shards)")
    ap.add_argument("--shards", type=int, default=1,
                    help="serve both tiers row-sharded over this many "
                         "shards (shard s on card s %% device count, or "
                         "all on the CPU with --device cpu); 1 = the "
                         "single-device path")
    ap.add_argument("--l1-capacity", type=int, default=0,
                    help="L1 exact-match front tier size; 0 = off")
    ap.add_argument("--volatile-bypass", action="store_true",
                    help="serve freshness-volatile prompts from the "
                         "backend with no cache read or write")
    ap.add_argument("--ttl-volatile", type=int, default=0,
                    help="entry lifetime (request ticks) of volatile-"
                         "class content; 0 = never expires")
    ap.add_argument("--ttl-stable", type=int, default=0,
                    help="entry lifetime of stable/unknown-class "
                         "content; 0 = never expires")
    ap.add_argument("--rewrite", action="store_true",
                    help="REWRITE verdicts: would-be rejects in the grey "
                         "zone get a tailored answer from the template "
                         "rewriter, promoted under the new prompt's key")
    ap.add_argument("--rewrite-rate", type=float, default=1.0,
                    help="rewrite token-bucket refill per judged task")
    ap.add_argument("--snapshot-dir", default=None,
                    help="restore the newest snapshot on start, replay "
                         "the promotion WAL tail, snapshot on shutdown")
    ap.add_argument("--wal", default=None,
                    help="promotion WAL path (default: "
                         "<snapshot-dir>/promo.wal with --snapshot-dir)")
    ap.add_argument("--wal-fsync-every", type=int, default=1,
                    help="fsync the WAL every N appends")
    ap.add_argument("--snapshot-every", type=int, default=0,
                    help="snapshot every N served requests (0 = only at "
                         "shutdown and on the stdio 'snapshot' op)")
    ap.add_argument("--adaptive", action="store_true",
                    help="online per-segment threshold controller")
    ap.add_argument("--adapt-every", type=int, default=256,
                    help="recorded requests between shadow sweeps")
    ap.add_argument("--adapt-window", type=int, default=1024,
                    help="request-window ring size of the shadow sweep")
    ap.add_argument("--adapt-frozen", action="store_true",
                    help="attach the controller but never move "
                         "thresholds")
    ap.add_argument("--serve-stdio", action="store_true",
                    help="run as a JSON-lines service on stdin/stdout "
                         "instead of the demo drive")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.shards < 1:
        ap.error(f"--shards {args.shards}: want at least 1")
    if args.fused and (args.index != "flat" or args.dyn_index != "flat"
                       or args.shards > 1):
        ap.error("--fused replaces both tier lookups; drop --index ivf / "
                 "--dyn-index segmented / --shards")

    from repro_torch.configs import smoke_config_for
    from repro_torch.core import promo_wal
    from repro_torch.distributed import checkpoint as ckpt
    from repro_torch.serving import persist

    snap = None
    if args.snapshot_dir and \
            persist.latest_snapshot(args.snapshot_dir) is not None:
        snap = persist.load_snapshot(args.snapshot_dir)
        print(f"snapshot: step {snap.step} (t={snap.extra['t']}, "
              f"wal_seq={snap.extra['wal_seq']})")
    wal_path = args.wal or (os.path.join(args.snapshot_dir, "promo.wal")
                            if args.snapshot_dir else None)
    wal = promo_wal.PromotionWAL(wal_path,
                                 fsync_every=args.wal_fsync_every) \
        if wal_path else None
    freshness = None
    if args.volatile_bypass or args.ttl_volatile or args.ttl_stable:
        from repro_torch.core.freshness import FreshnessPolicy
        freshness = FreshnessPolicy(volatile_bypass=args.volatile_bypass,
                                    ttl_volatile=args.ttl_volatile,
                                    ttl_stable=args.ttl_stable,
                                    ttl_unknown=args.ttl_stable)
        print(f"freshness: bypass={args.volatile_bypass} "
              f"ttl_volatile={args.ttl_volatile} "
              f"ttl_stable={args.ttl_stable}")
    if args.l1_capacity:
        print(f"l1 front tier: {args.l1_capacity} entries")
    if args.rewrite:
        print(f"rewrite verdicts: on (rate={args.rewrite_rate}/judged)")
    adaptive = None
    if args.adaptive:
        from repro_torch.core.adaptive import AdaptiveParams
        adaptive = AdaptiveParams(window=args.adapt_window,
                                  adapt_every=args.adapt_every)
        print(f"adaptive thresholds: window={args.adapt_window} "
              f"every={args.adapt_every} frozen={args.adapt_frozen}")

    service = build_service(smoke_config_for(args.arch, args.device),
                            device=args.device,
                            tau=args.tau, capacity=args.capacity,
                            static_rows=args.static_rows, index=args.index,
                            nprobe=args.nprobe, dyn_index=args.dyn_index,
                            seg_rows=args.seg_rows,
                            compact_every=args.compact_every,
                            fused=args.fused, l1_capacity=args.l1_capacity,
                            freshness=freshness, rewrite=args.rewrite,
                            rewrite_rate=args.rewrite_rate, wal=wal,
                            adaptive=adaptive,
                            adapt_frozen=args.adapt_frozen, snapshot=snap,
                            shards=args.shards)
    policy = service.policy
    recovered = {}
    try:
        # crash recovery: the newest snapshot, then the journal tail past
        # its cursor (the static index was warm-loaded or built above)
        if snap is not None:
            rep = persist.restore_policy(policy, snap, rebuild="never")
            print(f"restored: t={rep['t']} dyn_live={rep['dyn_live']} "
                  f"index={rep['index']} l1={rep['l1_restored']} "
                  f"ttl_dropped={rep['ttl_dropped']}")
            recovered.update(restored_step=rep["step"],
                             restored_t=rep["t"],
                             restored_dyn_live=rep["dyn_live"])
        if wal_path:
            r = promo_wal.replay_into(
                policy, wal_path,
                skip=snap.extra["wal_seq"] if snap else 0)
            print(f"wal replay: {r['replayed']} promotions (skipped "
                  f"{r['skipped']}, clean={r['clean']})")
            recovered.update(wal_replayed=r["replayed"],
                             wal_skipped=r["skipped"])

        def snapshot():
            path = persist.save_snapshot(args.snapshot_dir, policy)
            ckpt.prune(args.snapshot_dir, keep=3)
            return path

        if args.serve_stdio:
            _serve_stdio(policy, args.snapshot_dir, wal)
            s = policy.stats()
        else:
            t0 = time.time()
            reqs = demo_requests(args.requests)
            step = args.snapshot_every if args.snapshot_dir \
                and args.snapshot_every else len(reqs) or 1
            for lo in range(0, len(reqs), step):
                drive(service, reqs[lo:lo + step])
                if lo + step < len(reqs):
                    policy.pool.drain()
                    print(f"snapshot -> {snapshot().name}")
            policy.pool.drain()
            s = policy.stats()
            s.update({k: v for k, v in service.router.stats().items()
                      if k not in s})
            print(f"\nfinal ({time.time() - t0:.1f}s, device "
                  f"{policy.device}):")
            for k, v in s.items():
                print(f"  {k:22s} {v}")
        if args.snapshot_dir:
            # final snapshot, then drop the journal prefix it covers (the
            # WAL is closed first: compaction rewrites the file)
            policy.pool.drain()
            path = snapshot()
            print(f"  {'snapshot':22s} {path}")
            if wal is not None:
                seq = wal.seq
                wal.close()
                kept = promo_wal.compact(wal_path, keep_from_seq=seq)
                print(f"  {'wal_compacted':22s} {kept} records past the "
                      "snapshot")
    finally:
        service.stop()
        if wal is not None:
            wal.close()
    s.update(recovered)
    return s


if __name__ == "__main__":
    main()
