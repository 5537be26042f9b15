"""End-to-end example: Krites in front of a live LLM serving engine (the
PyTorch twin of ``examples/serve_cached_llm.py``).

  prompts -> hashing embedder -> tiered cache (KritesPolicy)
         -> on miss: the LLM engine (a smoke-size qwen3-family model,
            prefill + KV-cache decode: the flash and decode attention
            kernels on the card)
         -> grey-zone misses feed the async VerifyAndPromote pool
            (oracle judge over prompt-template classes)

Prompts are generated from intent templates with paraphrase prefixes, so
the embedder clusters same-intent phrasings, the structure the cache
exploits. The static-origin share climbs as promotions land, with the
serving path unchanged.

    PYTHONPATH=src python -m repro_torch.examples.serve_cached_llm [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import smoke_config_for
from repro_torch.core.judge import OracleJudge
from repro_torch.core.policy import BaselinePolicy, KritesPolicy
from repro_torch.core.tiers import CacheConfig, make_static_tier
from repro_torch.device import get_device
from repro_torch.embedding.embedder import Embedder
from repro_torch.serving.engine import LLMEngine

# ---- intent classes: templates + paraphrase prefixes ---------------------
TEMPLATES = [
    "can my dog eat honey", "resync my smart watch", "weather in lisbon",
    "best pizza dough recipe", "fix a flat bike tire", "tax deadline 2026",
    "learn python quickly", "remove red wine stain", "cheap flights to nyc",
    "why is the sky blue", "битcoin price today", "how tall is everest",
    "reset my router password", "symptoms of the flu", "tip in portugal",
    "convert miles to km", "who won the lottery last night",
    "plant tomatoes in july", "laptop battery drains fast",
    "make cold brew coffee",
]
PREFIXES = ["", "hey, ", "quick question: ", "um ", "what's the word on ",
            "anybody know ", "pls tell me ", "I wonder, "]


def make_prompt(cls: int, phrasing: int) -> str:
    return PREFIXES[phrasing % len(PREFIXES)] + TEMPLATES[cls]


def main(argv=None, *, n_requests: int = 400) -> dict:
    """Serve ``n_requests`` through the baseline and through Krites;
    returns {"baseline": stats, "krites": stats}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = get_device(args.device)

    embed = Embedder(d_out=64, device=device)
    print("building tiny LLM backend (prefill+decode engine)...")
    # on the card the smoke config takes head dim 64, which the
    # attention kernels take
    engine = LLMEngine(smoke_config_for("qwen3-1.7b", device), max_len=96,
                       device=device)

    # static tier: one curated answer per intent (canonical phrasing)
    canon = [make_prompt(c, 0) for c in range(len(TEMPLATES))]
    static_emb = embed.batch(canon)
    static_answers = [f"[curated#{c}] {TEMPLATES[c]} -> vetted answer"
                      for c in range(len(TEMPLATES))]
    tier = make_static_tier(static_emb, np.arange(len(TEMPLATES)),
                            device=device)

    cfg = CacheConfig(tau_static=0.92, tau_dynamic=0.92, sigma_min=0.3,
                      capacity=256)
    judge = OracleJudge()

    def backend(prompt: str) -> str:
        return engine.generate(prompt, max_new_tokens=8)

    def run(policy, n=n_requests, seed=1):
        r = np.random.default_rng(seed)
        lat = []
        for _ in range(n):
            cls = int(r.integers(0, len(TEMPLATES)))
            phr = int(r.integers(0, len(PREFIXES)))
            t0 = time.monotonic()
            policy.serve(make_prompt(cls, phr), meta={"cls": cls})
            lat.append(time.monotonic() - t0)
        if hasattr(policy, "pool"):
            policy.pool.drain()
        s = policy.stats()
        s["p50_latency_ms"] = round(1e3 * float(np.median(lat)), 2)
        s["p99_latency_ms"] = round(
            1e3 * float(np.percentile(lat, 99)), 2)
        return s

    base = BaselinePolicy(cfg, tier, static_answers, embed, backend, d=64,
                          device=device)
    # the judge pool sees the full (q_text, h_text, answer) triple:
    # static_texts are the curated entries' canonical phrasings
    krites = KritesPolicy(cfg, tier, static_answers, embed, backend,
                          judge, d=64, static_texts=canon, device=device)
    try:
        print(f"\nserving {n_requests} requests through each policy...")
        sb = run(base)
        sk = run(krites)
    finally:
        krites.pool.stop()
    for name, s in (("baseline", sb), ("krites", sk)):
        print(f"\n{name}:")
        for k, v in s.items():
            print(f"  {k:22s} {v}")
    gain = sk["static_origin_rate"] / max(sb["static_origin_rate"],
                                          1e-9) - 1
    print(f"\nstatic-origin: {sb['static_origin_rate']:.3f} -> "
          f"{sk['static_origin_rate']:.3f} (+{100*gain:.0f}%), "
          f"p50 latency {sb['p50_latency_ms']}ms -> "
          f"{sk['p50_latency_ms']}ms (serving path unchanged)")
    return {"baseline": sb, "krites": sk}


if __name__ == "__main__":
    main()
