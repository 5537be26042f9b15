"""Batched LLM serving engine: prefill + decode with a KV cache, plus a
continuous-batching-lite request queue (port of
``repro/serving/engine.py``).

The engine is the backend that Krites fronts: every cache hit is a
skipped ``generate`` call. It runs on ``cuda`` unless built with
``device="cpu"``. It decodes greedily at ``temperature <= 0`` and by
Gumbel-max sampling above it, with noise from its own generator on its
device.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from repro_torch.configs.base import LMConfig
from repro_torch.data.tokenizer import ByteTokenizer, EOS
from repro_torch.device import get_device
from repro_torch.models import transformer as tr


@dataclass
class EngineStats:
    prefills: int = 0
    decode_steps: int = 0
    generated_tokens: int = 0
    batches: int = 0
    wall_prefill_s: float = 0.0
    wall_decode_s: float = 0.0


class LLMEngine:
    """Synchronous batched generate; thread-safe via internal lock."""

    def __init__(self, cfg: LMConfig, params=None, seed: int = 0,
                 max_len: int = 256, temperature: float = 0.0,
                 device=None):
        self.cfg = cfg
        self.device = get_device(device)
        self.tok = ByteTokenizer()
        if cfg.vocab_size < self.tok.vocab_size:
            raise ValueError(f"vocab {cfg.vocab_size} < tokenizer's "
                             f"{self.tok.vocab_size}")
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = tr.init_params(cfg, gen, self.device)
        self.params = params
        self.max_len = max_len
        self.temperature = temperature
        # the sampler's noise: its own generator on the engine's device,
        # seeded from ``seed`` (the reference draws from numpy's global
        # generator on the host)
        self._noise_gen = torch.Generator(device=self.device) \
            .manual_seed(seed)
        self.stats = EngineStats()
        self._lock = threading.Lock()

    def generate_batch(self, prompts: List[str],
                       max_new_tokens: int = 32) -> List[str]:
        with self._lock:
            return self._generate(prompts, max_new_tokens)

    def _generate(self, prompts: List[str], max_new: int) -> List[str]:
        B = len(prompts)
        in_len = max(8, max(len(p.encode()) + 2 for p in prompts))
        in_len = min(in_len, self.max_len - max_new)
        toks = np.stack([self.tok.encode(p, max_len=in_len)
                         for p in prompts])
        t0 = time.monotonic()
        logits, cache = tr.prefill(
            self.cfg, self.params,
            torch.from_numpy(toks).to(self.device, torch.int64),
            max_len=self.max_len)
        self.stats.prefills += B
        self.stats.wall_prefill_s += time.monotonic() - t0

        out = [[] for _ in range(B)]
        done = np.zeros(B, bool)
        tok = self._sample(logits)
        t0 = time.monotonic()
        for _ in range(max_new):
            for b in range(B):
                if not done[b]:
                    out[b].append(int(tok[b]))
                    done[b] |= int(tok[b]) == EOS
            if done.all():
                break
            logits, cache = tr.decode_step(
                self.cfg, self.params, cache,
                torch.from_numpy(tok).to(self.device, torch.int64))
            self.stats.decode_steps += 1
            tok = self._sample(logits)
        self.stats.wall_decode_s += time.monotonic() - t0
        self.stats.generated_tokens += sum(len(o) for o in out)
        self.stats.batches += 1
        return [self.tok.decode(o) for o in out]

    def gumbel(self, shape) -> torch.Tensor:
        """Standard Gumbel noise of ``shape``, fp32, drawn on the engine's
        device from its generator as ``-log(E)`` with ``E ~
        Exponential(1)``. ``E`` is clamped to at least the smallest
        normal fp32 (1.2e-38), so a draw of ``E = 0`` gives 87.3, not
        ``+inf`` (which would win the argmax whatever the logits), and a
        finite ``E`` never gives NaN. Tests replace this method to feed
        the engine the reference's noise."""
        e = torch.empty(shape, dtype=torch.float32, device=self.device)
        e.exponential_(generator=self._noise_gen)
        return -torch.log(e.clamp_min_(torch.finfo(torch.float32).tiny))

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        """Greedy at ``temperature <= 0``: argmax over the fp32 logits.
        Otherwise Gumbel-max, ``argmax(logits / T + g)`` in fp32 in the
        reference's order (a true division by fp32 ``T``, then the add),
        ``g`` a draw of :meth:`gumbel` of ``logits``' shape, cast to
        fp32. ``argmax`` takes the first maximum, as ``jnp.argmax``
        does."""
        if self.temperature <= 0:
            return torch.argmax(logits, -1).to(torch.int32).cpu().numpy()
        g = self.gumbel(logits.shape).to(logits.device, torch.float32)
        # a tensor divisor: CUDA turns division by a Python scalar into a
        # product with its rounded reciprocal
        t = torch.full((), self.temperature, dtype=torch.float32,
                       device=logits.device)
        scores = logits.to(torch.float32) / t + g
        return torch.argmax(scores, -1).to(torch.int32).cpu().numpy()

    def generate(self, prompt: str, max_new_tokens: int = 32) -> str:
        return self.generate_batch([prompt], max_new_tokens)[0]


class BatchingFrontend:
    """Continuous-batching-lite: coalesce concurrent requests into
    engine batches (max_batch or max_wait_ms, whichever first), through
    the same ``_MicroBatcher`` that ``CacheRouter`` uses."""

    def __init__(self, engine: LLMEngine, max_batch: int = 8,
                 max_wait_ms: float = 5.0, max_new_tokens: int = 32):
        from repro_torch.serving.router import _MicroBatcher
        self.engine = engine
        self.max_new = max_new_tokens
        self._mb = _MicroBatcher(self._serve, max_batch, max_wait_ms / 1e3,
                                 name="batching-frontend")

    @property
    def failed_batches(self) -> int:
        """Engine batches whose ``generate_batch`` raised."""
        return self._mb.failed_batches

    def submit(self, prompt: str, timeout_s: float = 60.0) -> str:
        return self._answer(self._mb.submit(prompt), timeout_s)

    def submit_many(self, prompts: List[str],
                    timeout_s: float = 60.0) -> List[str]:
        """Enqueue a pre-formed group and block until every answer is
        in; usable as a policy's ``backend_batch_fn``, so a cache
        micro-batch's misses become one engine prefill."""
        pending = [self._mb.submit(p) for p in prompts]
        return [self._answer(p, timeout_s) for p in pending]

    @staticmethod
    def _answer(p, timeout_s: float) -> str:
        """The request's answer; raises if its engine batch failed or did
        not finish in time, so the caller (the policy, then the router)
        sees the failure instead of caching an empty answer."""
        if not p.done.wait(timeout_s):
            raise TimeoutError(f"engine gave no answer in {timeout_s}s")
        if p.error is not None:
            raise RuntimeError("engine batch failed") from p.error
        return p.result

    def _serve(self, batch):
        results = self.engine.generate_batch(
            [p.prompt for p in batch], self.max_new)
        for p, r in zip(batch, results):
            p.result = r

    def stop(self):
        self._mb.stop()
