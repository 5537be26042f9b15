"""Synthetic graphs + a real neighbor sampler (GraphSAGE minibatch path;
a numpy copy of ``repro/data/graph_data.py``: for the same arguments and
seed it returns the same arrays). Two steps are computed another way with
the same result, for graphs of 10^8 edges: ``build_csr``'s stable
argsort by destination is one sort of unique (destination, position)
keys and its counts a ``bincount``; ``_same_class_target`` finds each
class's edges by one sort of unique (class, position) keys, not by a
mask a class. ``synthetic_graph_without_csr`` is
``synthetic_graph`` without the CSR, for callers that read only the
edge list.

``NeighborSampler`` implements the paper's fixed-fanout sampling over a
CSR adjacency — the host-side component that feeds ``minibatch_lg``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Tuple

import numpy as np


@dataclass
class Graph:
    n_nodes: int
    edges: np.ndarray        # (E, 2) int32 [src, dst]
    feats: np.ndarray        # (N, F) float32
    labels: np.ndarray       # (N,) int32
    indptr: np.ndarray = None
    indices: np.ndarray = None

    def build_csr(self):
        dst = self.edges[:, 1]
        # the stable argsort of dst: unique keys (dst, edge position)
        bits = max(1, len(dst)).bit_length()
        keys = (dst.astype(np.int64) << bits) | np.arange(len(dst))
        order = np.sort(keys) & ((1 << bits) - 1)
        self.indices = self.edges[order, 0].astype(np.int32)
        counts = np.bincount(dst, minlength=self.n_nodes).astype(np.int64)
        self.indptr = np.cumsum(np.concatenate([np.zeros(1, np.int64),
                                                counts]))
        return self


def synthetic_graph(n_nodes: int, avg_degree: int, d_feat: int,
                    n_classes: int, seed: int = 0,
                    homophily: float = 0.8) -> Graph:
    """Degree-skewed community graph with homophilous edges (so GraphSAGE
    can actually learn: features carry class signal, neighbors agree)."""
    return synthetic_graph_without_csr(n_nodes, avg_degree, d_feat,
                                       n_classes, seed, homophily).build_csr()


def synthetic_graph_without_csr(n_nodes: int, avg_degree: int,
                                d_feat: int, n_classes: int, seed: int = 0,
                                homophily: float = 0.8) -> Graph:
    """:func:`synthetic_graph` without the CSR (``indptr`` and
    ``indices`` None)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, n_nodes).astype(np.int32)
    centers = rng.standard_normal((n_classes, d_feat)).astype(np.float32)
    feats = centers[labels] + 0.8 * rng.standard_normal(
        (n_nodes, d_feat)).astype(np.float32)

    n_edges = n_nodes * avg_degree
    src = rng.integers(0, n_nodes, n_edges)
    same = rng.random(n_edges) < homophily
    dst = np.where(
        same,
        # rewire to a random node of the same class
        _same_class_target(rng, labels, src, n_classes),
        rng.integers(0, n_nodes, n_edges))
    edges = np.stack([src, dst], 1).astype(np.int32)
    return Graph(n_nodes, edges, feats, labels)


def _same_class_target(rng, labels, src, n_classes):
    by_class = [np.where(labels == c)[0] for c in range(n_classes)]
    out = np.empty_like(src)
    # the edges of each source class in edge order: one sort of unique
    # (class, position) keys, not a mask a class
    src_labels = labels[src]
    bits = max(1, len(src)).bit_length()
    keys = (src_labels.astype(np.int64) << bits) | np.arange(len(src))
    order = np.sort(keys) & ((1 << bits) - 1)
    ends = np.cumsum(np.bincount(src_labels, minlength=n_classes))
    for c in range(n_classes):
        pool = by_class[c]
        lo = ends[c - 1] if c else 0
        out[order[lo:ends[c]]] = pool[rng.integers(0, len(pool),
                                                   ends[c] - lo)]
    return out


class NeighborSampler:
    """Fixed-fanout neighbor sampling over CSR adjacency (with
    replacement, as in the GraphSAGE reference implementation)."""

    def __init__(self, graph: Graph, fanout: Tuple[int, ...],
                 seed: int = 0):
        assert graph.indptr is not None, "call build_csr() first"
        self.g = graph
        self.fanout = fanout
        self.rng = np.random.default_rng(seed)

    def sample_neighbors(self, nodes: np.ndarray, k: int) -> np.ndarray:
        """(B,) -> (B, k) sampled in-neighbors (self-loop if isolated)."""
        out = np.empty((len(nodes), k), np.int64)
        for i, n in enumerate(nodes):
            lo, hi = self.g.indptr[n], self.g.indptr[n + 1]
            if hi > lo:
                out[i] = self.g.indices[
                    self.rng.integers(lo, hi, k)]
            else:
                out[i] = n
        return out

    def sample_batch(self, batch_nodes: np.ndarray) -> dict:
        """Returns feat_l0 (B,F), feat_l1 (B,f1,F), feat_l2 (B,f1,f2,F)...
        + labels — the dense layout minibatch_forward consumes."""
        levels = [batch_nodes.astype(np.int64)]
        for k in self.fanout:
            flat = levels[-1].reshape(-1)
            nxt = self.sample_neighbors(flat, k)
            levels.append(nxt.reshape(*levels[-1].shape, k))
        batch = {f"feat_l{i}": self.g.feats[lvl]
                 for i, lvl in enumerate(levels)}
        batch["labels"] = self.g.labels[batch_nodes]
        return batch

    def batches(self, batch_size: int, seed: int = 0) -> Iterator[dict]:
        rng = np.random.default_rng(seed)
        while True:
            nodes = rng.integers(0, self.g.n_nodes, batch_size)
            yield self.sample_batch(nodes)


def batched_molecules(n_graphs: int, n_nodes: int, n_edges: int,
                      d_feat: int, n_classes: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal(
        (n_graphs, n_nodes, d_feat)).astype(np.float32)
    edges = rng.integers(0, n_nodes,
                         (n_graphs, n_edges, 2)).astype(np.int32)
    mask = rng.random((n_graphs, n_edges)) < 0.9
    labels = rng.integers(0, n_classes, n_graphs).astype(np.int32)
    return {"feats": feats, "edges": edges, "edge_mask": mask,
            "labels": labels}
