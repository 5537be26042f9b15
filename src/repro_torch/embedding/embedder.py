"""Prompt embedder for the live serving stack.

Port of ``repro/embedding/embedder.py``: a hashing character-n-gram
featurizer on the host (``hash_features``, copied as is) feeding a small
two-layer MLP with L2-normalized output, here in torch. The JAX
weights are drawn from ``jax.random.PRNGKey(seed)``, which torch cannot
reproduce, so :class:`Embedder` takes ``w1``/``w2`` by value (a parity
test copies them from the JAX instance) or draws them with the same
distributions from a ``torch.Generator`` seeded with ``seed``.
"""
from __future__ import annotations

import hashlib
import re

import numpy as np
import torch

from repro_torch.device import get_device


def _ngrams(text: str, lo: int = 2, hi: int = 4):
    t = re.sub(r"\s+", " ", text.lower().strip())
    for n in range(lo, hi + 1):
        for i in range(max(len(t) - n + 1, 0)):
            yield t[i:i + n]
    for w in t.split(" "):
        yield "w:" + w


def hash_features(text: str, n_features: int = 1024) -> np.ndarray:
    """Signed feature hashing of char n-grams + words."""
    x = np.zeros((n_features,), np.float32)
    for g in _ngrams(text):
        h = int.from_bytes(
            hashlib.blake2s(g.encode(), digest_size=8).digest(), "little")
        idx = h % n_features
        sign = 1.0 if (h >> 63) & 1 else -1.0
        x[idx] += sign
    n = np.linalg.norm(x)
    return x / n if n > 0 else x


def _weight(w) -> torch.Tensor:
    return w if isinstance(w, torch.Tensor) else torch.tensor(np.asarray(w))


class Embedder:
    """Text -> (d_out,) unit vector. Callable on one text; ``batch`` on
    a list. Returns numpy arrays, as the JAX embedder does."""

    def __init__(self, d_out: int = 64, n_features: int = 1024,
                 seed: int = 7, w1=None, w2=None, device=None):
        self.d_out, self.n_features, self.seed = d_out, n_features, seed
        self.device = get_device(device)
        h = 4 * d_out
        if w1 is None or w2 is None:
            g = torch.Generator().manual_seed(seed)
            w1 = torch.randn((n_features, h), generator=g) \
                * n_features ** -0.5
            w2 = torch.randn((h, d_out), generator=g) * h ** -0.5
        self.w1 = _weight(w1).to(self.device, torch.float32)
        self.w2 = _weight(w2).to(self.device, torch.float32)

    def _forward(self, feats: torch.Tensor) -> torch.Tensor:
        z = torch.tanh(feats @ self.w1) @ self.w2
        return z / torch.clamp(torch.linalg.vector_norm(z, dim=-1,
                                                        keepdim=True),
                               min=1e-9)

    def __call__(self, text: str) -> np.ndarray:
        return self.batch([text])[0]

    def batch(self, texts) -> np.ndarray:
        feats = np.stack([hash_features(t, self.n_features) for t in texts])
        out = self._forward(torch.from_numpy(feats).to(self.device))
        return out.cpu().numpy()
