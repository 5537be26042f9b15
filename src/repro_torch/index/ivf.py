"""IVF quantized ANN index for the static tier (port of
``repro/index/ivf.py``).

- **training**: spherical k-means (``train_kmeans``) over the
  L2-normalized corpus: cosine argmax assignment, renormalized centroid
  updates, empty clusters keep their previous centroid;
- **layout** (``build_ivf``): a packed cluster-major corpus. Every
  cluster owns a fixed-capacity band of slots holding int8 codes
  (symmetric per-row scale ``max|x|/127``), the fp32 scales, and the
  member rows' global ids (-1 padding);
- **search** (``IVFIndex``): centroid scoring -> top-``nprobe`` clusters
  -> int8 scan of those bands (``kernels/ivf_scan``, the CUDA kernel on
  the card) -> exact fp32 rerank of the top-``n_candidates`` against
  the corpus rows.

The rerank makes the served (score, index) pairs equal to flat search
whenever the true nearest row lands in the candidate set (recall@C).

The k-means seeding cannot reproduce the reference's
``jax.random.choice`` bits, so a layout built here differs from one
built by the JAX package; ``ivf_from_numpy`` takes a layout built
elsewhere as it is.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import get_device
from repro_torch.index.flat import l2_normalize
from repro_torch.kernels.ivf_scan.ops import ivf_search
from repro_torch.kernels.simsearch.ref import topk_lowest_index


class IVF(NamedTuple):
    """Packed cluster-major IVF layout (tensors on one device)."""
    centroids: torch.Tensor   # (K, d) fp32, L2-normalized
    codes: torch.Tensor       # (K, cap, d) int8 quantized rows
    scales: torch.Tensor      # (K, cap) fp32 per-row dequant scale
    row_ids: torch.Tensor     # (K, cap) int32 global row id, -1 = pad
    corpus: torch.Tensor      # (N, d) fp32 normalized: the rerank rows


def _assign(x: torch.Tensor, cent: torch.Tensor,
            chunk: int = 65536) -> torch.Tensor:
    """Cosine argmax cluster of every row (first maximum on ties), in
    row chunks to bound the (rows, K) score buffer."""
    return torch.cat([torch.argmax(x[lo:lo + chunk] @ cent.T, dim=1)
                      for lo in range(0, x.shape[0], chunk)])


def train_kmeans(corpus: torch.Tensor, n_clusters: int, iters: int = 6,
                 seed: int = 0) -> torch.Tensor:
    """Spherical k-means centroids over an L2-normalized corpus.

    The initial centroids are rows drawn by a CPU ``torch.Generator``
    seeded with ``seed`` (without replacement unless the corpus has
    fewer rows than clusters), so a seed gives the same start on any
    device. The reference draws them with ``jax.random.choice``, whose
    bits differ. Cluster sums use ``index_put_`` with accumulation,
    which is deterministic on the card."""
    n = corpus.shape[0]
    x = corpus.to(torch.float32)
    gen = torch.Generator().manual_seed(seed)
    init = torch.randint(0, n, (n_clusters,), generator=gen) \
        if n < n_clusters else torch.randperm(n, generator=gen)[:n_clusters]
    cent = x[init.to(x.device)]
    for _ in range(iters):
        assign = _assign(x, cent)
        sums = torch.zeros_like(cent).index_put_((assign,), x,
                                                 accumulate=True)
        counts = torch.bincount(assign, minlength=n_clusters) \
            .to(torch.float32)
        new = l2_normalize(sums / counts.clamp(min=1.0)[:, None])
        cent = torch.where(counts[:, None] > 0, new, cent)
    return cent


def quantize_rows(rows: np.ndarray):
    """Symmetric per-row int8 scalar quantization (numpy, as the
    reference): code = round(x / s), s = max|x| / 127; the dequant error
    per component is at most s/2."""
    rows = np.asarray(rows, np.float32)
    scale = np.abs(rows).max(axis=1) / 127.0
    safe = np.where(scale > 0, scale, 1.0)
    codes = np.clip(np.rint(rows / safe[:, None]), -127, 127)
    return codes.astype(np.int8), scale.astype(np.float32)


def default_n_clusters(n_rows: int) -> int:
    """4*sqrt(N) clusters, capped so clusters keep >= 64 rows (the
    reference's operating range; see ``repro/index/ivf.py``)."""
    return max(8, min(int(round(4 * math.sqrt(n_rows))),
                      n_rows // 64 or 1))


def _topk_clusters_host(c: torch.Tensor, cent: torch.Tensor, nchoice: int,
                        chunk: int = 65536):
    """Per-row top-``nchoice`` cluster choices (numpy ids + sims),
    descending, lowest cluster id on ties, computed on the corpus's
    device in row chunks to bound the (N, K) score buffer."""
    ids, sims = [], []
    for lo in range(0, c.shape[0], chunk):
        s, i = topk_lowest_index(c[lo:lo + chunk] @ cent.T, nchoice)
        ids.append(i.cpu().numpy())
        sims.append(s.cpu().numpy())
    return np.concatenate(ids), np.concatenate(sims)


def _greedy_round(pending, want, sims, assign, load, cap):
    """One contended-assignment round: among ``pending`` rows, each
    wanting cluster ``want[i]`` with similarity ``sims[i]``,
    higher-similarity rows win the cluster's remaining slots. Mutates
    ``assign``/``load``; returns the still-unassigned rows."""
    K = len(load)
    by_sim = np.argsort(-sims, kind="stable")
    w = want[by_sim]
    order = np.argsort(w, kind="stable")
    w_sorted = w[order]
    starts = np.searchsorted(w_sorted, np.arange(K))
    rank = np.arange(len(w)) - starts[w_sorted]
    ok = rank < (cap - load)[w_sorted]
    rows = pending[by_sim[order[ok]]]
    assign[rows] = w_sorted[ok]
    load += np.bincount(w_sorted[ok], minlength=K)
    return pending[assign[pending] < 0]


def _balanced_assign(c: torch.Tensor, cent: torch.Tensor, cap: int,
                     nchoice: int = 8) -> np.ndarray:
    """Capacity-bounded cluster assignment: each row goes to its best
    centroid that still has a free slot (spilling to its 2nd..n-th
    choice), higher-similarity rows winning contended slots."""
    n = c.shape[0]
    K = cent.shape[0]
    assert cap * K >= n, (cap, K, n)
    choice_ids, choice_sims = _topk_clusters_host(c, cent, min(K, nchoice))
    assign = np.full(n, -1, np.int64)
    load = np.zeros(K, np.int64)
    pending = np.arange(n)
    for r in range(choice_ids.shape[1]):
        if not len(pending):
            break
        pending = _greedy_round(pending, choice_ids[pending, r],
                                choice_sims[pending, r], assign, load,
                                cap)
    while len(pending):
        # every listed choice is full (rare): re-rank the leftovers
        # against the clusters that still have space
        rows = torch.from_numpy(pending).to(c.device)
        sims = (c[rows] @ cent.T).cpu().numpy()
        sims[:, load >= cap] = -np.inf
        want = sims.argmax(axis=1)
        best = sims[np.arange(len(pending)), want]
        pending = _greedy_round(pending, want, best, assign, load, cap)
    return assign


def build_ivf(corpus, n_clusters: int | None = None, *, iters: int = 6,
              seed: int = 0, corpus_normalized: bool = False,
              train_rows: int | None = 131072, cap: int | None = None,
              cap_multiple: int = 8, max_imbalance: float | None = 1.3,
              device=None) -> IVF:
    """Train and pack an IVF index over ``corpus`` (N, d), as the
    reference does (see its docstring for ``train_rows``,
    ``max_imbalance`` and ``cap``).

    ``corpus`` is a tensor (the layout goes to its device unless
    ``device`` says otherwise) or an array (copied to ``device``,
    default ``cuda``). With ``corpus_normalized=True`` a float32 tensor
    already on that device becomes ``IVF.corpus`` as it is, without a
    copy: the static tier's 1 GiB of rows is then held once, shared by
    the tier and its index. The assignment and the packing run on the
    host in numpy, as in the reference; the matmuls on the device."""
    if isinstance(corpus, torch.Tensor):
        dev = corpus.device if device is None else get_device(device)
        c = corpus.to(device=dev, dtype=torch.float32)
    else:
        dev = get_device(device)
        c = torch.tensor(np.asarray(corpus, np.float32), device=dev)
    if not corpus_normalized:
        c = l2_normalize(c)
    c = c.contiguous()
    n, d = c.shape
    K = n_clusters or default_n_clusters(n)

    train = c
    if train_rows is not None and n > train_rows:
        sub = np.random.default_rng(seed).choice(n, train_rows,
                                                 replace=False)
        train = c[torch.from_numpy(sub).to(dev)]
    cent = train_kmeans(train, K, iters=iters, seed=seed)

    if cap is None and max_imbalance is not None:
        want = int(math.ceil(n / K * max_imbalance))
        cap = -(-max(1, want) // cap_multiple) * cap_multiple
    if cap is not None:
        if cap * K < n:
            raise ValueError(f"cap={cap} x K={K} < corpus rows {n}")
        assign = _balanced_assign(c, cent, cap)
    else:
        assign = _assign(c, cent).cpu().numpy()
        need = max(1, int(np.bincount(assign, minlength=K).max()))
        cap = -(-need // cap_multiple) * cap_multiple

    # cluster-major packing: stable sort by cluster, slot = rank within
    order = np.argsort(assign, kind="stable")
    sorted_assign = assign[order]
    starts = np.searchsorted(sorted_assign, np.arange(K))
    slot = np.arange(n) - starts[sorted_assign]

    all_codes, all_scales = quantize_rows(c.cpu().numpy())
    codes = np.zeros((K, cap, d), np.int8)
    scales = np.zeros((K, cap), np.float32)
    row_ids = np.full((K, cap), -1, np.int32)
    codes[sorted_assign, slot] = all_codes[order]
    scales[sorted_assign, slot] = all_scales[order]
    row_ids[sorted_assign, slot] = order

    return IVF(cent.contiguous(), torch.from_numpy(codes).to(dev),
               torch.from_numpy(scales).to(dev),
               torch.from_numpy(row_ids).to(dev), c)


def ivf_from_numpy(centroids, codes, scales, row_ids, corpus,
                   device=None) -> IVF:
    """An IVF layout built elsewhere (e.g. by the JAX package, or read
    from a snapshot), carried over array by array onto ``device``
    (default ``cuda``). A tensor already on ``device`` with the layout's
    dtype (say the static tier's rows as ``corpus``) is taken without a
    copy."""
    dev = get_device(device)

    def t(x, dtype):
        if isinstance(x, torch.Tensor):
            return x.to(device=dev, dtype=dtype).contiguous()
        return torch.tensor(np.asarray(x), device=dev).to(dtype) \
            .contiguous()
    return IVF(t(centroids, torch.float32), t(codes, torch.int8),
               t(scales, torch.float32), t(row_ids, torch.int32),
               t(corpus, torch.float32))


@dataclass(frozen=True)
class IVFIndex:
    """Injectable ANN index: IVF scan + exact rerank behind ``topk``."""
    ivf: IVF
    nprobe: int = 8
    n_candidates: int = 32

    def topk(self, queries: torch.Tensor, k: int = 1):
        """queries (B, d) L2-normalized -> (scores (B, k), idx (B, k))."""
        return ivf_search(queries, self.ivf.corpus, self.ivf.centroids,
                          self.ivf.codes, self.ivf.scales,
                          self.ivf.row_ids, k=k, nprobe=self.nprobe,
                          n_candidates=self.n_candidates)

    def describe(self) -> str:
        K, cap, d = self.ivf.codes.shape
        return (f"ivf(N={self.ivf.corpus.shape[0]}, K={K}, cap={cap}, "
                f"d={d}, nprobe={self.nprobe}, C={self.n_candidates})")
