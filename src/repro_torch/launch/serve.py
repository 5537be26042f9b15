"""Serving launcher: Krites-fronted LLM engine with request batching
(port of ``repro/launch/serve.py``, batched flat path only).

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 200
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu

Wires embedder -> KritesPolicy (tiered cache + async judge pool) ->
BatchingFrontend -> LLMEngine, and drives it through ``CacheRouter``:
concurrent clients submit requests, the router coalesces them into
micro-batches for ``KritesPolicy.serve_batch``, whose misses reach the
engine as one ``BatchingFrontend.submit_many`` group. The LM config is
an argument of :func:`build_service`; the command line keeps the JAX
launcher's ``smoke_config`` default. Runs on ``cuda`` unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import threading
import time
from dataclasses import dataclass

import numpy as np

DEMO_INTENTS = [f"how do i {v} my {n}" for v in
                ("fix", "update", "reset", "clean", "sell")
                for n in ("bike", "laptop", "router", "garden")]
DEMO_PREFIXES = ["", "hey ", "um, ", "please, ", "quick q: "]

# flags of the JAX launcher that this port does not take yet
_UNPORTED_FLAGS = (
    "--shards", "--index", "--nprobe", "--fused", "--dyn-index",
    "--seg-rows", "--compact-every", "--l1-capacity", "--volatile-bypass",
    "--ttl-volatile", "--ttl-stable", "--rewrite", "--rewrite-rate",
    "--snapshot-dir", "--wal", "--wal-fsync-every", "--snapshot-every",
    "--adaptive", "--adapt-every", "--adapt-window", "--adapt-frozen",
    "--serve-stdio",
)


def build_demo_tier(emb_rows, answers, static_rows: int = 0, texts=None,
                    device=None):
    """Pad the curated tier with synthetic entries to ``static_rows``
    rows (random directions from ``np.random.default_rng(7)``, each its
    own answer class, as in the JAX launcher) and build the flat static
    tier on ``device``. Returns (StaticTier, answers, texts)."""
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
    tier = make_static_tier(emb_rows, np.arange(len(answers)),
                            device=device)
    return tier, answers, texts


@dataclass
class Service:
    """The wired serving stack; ``stop()`` ends every thread it runs."""
    policy: object
    router: object
    frontend: object
    engine: object

    def stop(self) -> None:
        self.router.stop()
        self.policy.pool.stop()
        self.frontend.stop()


def build_service(lm_cfg, *, device=None, tau: float = 0.92,
                  capacity: int = 512, static_rows: int = 0,
                  max_len: int = 96, max_new_tokens: int = 8,
                  router_batch: int = 32, engine_batch: int = 8,
                  params=None, seed: int = 0) -> Service:
    """Embedder -> KritesPolicy -> BatchingFrontend -> LLMEngine behind a
    CacheRouter, for the LM config ``lm_cfg`` on ``device`` (default
    ``cuda``)."""
    from repro_torch.core.judge import OracleJudge
    from repro_torch.core.policy import KritesPolicy
    from repro_torch.core.tiers import CacheConfig
    from repro_torch.device import get_device
    from repro_torch.embedding.embedder import Embedder
    from repro_torch.serving.engine import BatchingFrontend, LLMEngine
    from repro_torch.serving.router import CacheRouter

    dev = get_device(device)
    embed = Embedder(d_out=64, device=dev)
    engine = LLMEngine(lm_cfg, params=params, seed=seed, max_len=max_len,
                       device=dev)
    frontend = BatchingFrontend(engine, max_batch=engine_batch,
                                max_new_tokens=max_new_tokens)
    canon = DEMO_INTENTS
    tier, answers, texts = build_demo_tier(
        embed.batch(canon), [f"[curated] {p}" for p in canon],
        static_rows=static_rows, texts=canon, device=dev)
    cfg = CacheConfig(tau, tau, sigma_min=0.3, capacity=capacity)
    policy = KritesPolicy(cfg, tier, answers, embed,
                          backend_fn=frontend.submit,
                          judge_fn=OracleJudge(), d=64,
                          backend_batch_fn=frontend.submit_many,
                          static_texts=texts, device=dev)
    router = CacheRouter(policy, max_batch=router_batch)
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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--tau", type=float, default=0.92)
    ap.add_argument("--capacity", type=int, default=512,
                    help="dynamic-tier capacity")
    ap.add_argument("--static-rows", type=int, default=0,
                    help="pad the curated tier to this many rows with "
                         "synthetic entries")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args, rest = ap.parse_known_args(argv)
    for flag in rest:
        name = flag.split("=")[0]
        if name in _UNPORTED_FLAGS:
            ap.error(f"{name} is a flag of the JAX launcher that the "
                     "PyTorch port does not take yet (see ROADMAP.md)")
    if rest:
        ap.error(f"unrecognized arguments: {' '.join(rest)}")

    from repro_torch.configs import smoke_config
    service = build_service(smoke_config(args.arch), device=args.device,
                            tau=args.tau, capacity=args.capacity,
                            static_rows=args.static_rows)
    try:
        t0 = time.time()
        drive(service, demo_requests(args.requests))
        service.policy.pool.drain()
        s = service.policy.stats()
        s.update({k: v for k, v in service.router.stats().items()
                  if k not in s})
        print(f"\nfinal ({time.time() - t0:.1f}s, device "
              f"{service.policy.device}):")
        for k, v in s.items():
            print(f"  {k:22s} {v}")
    finally:
        service.stop()


if __name__ == "__main__":
    main()
