"""Concrete single-card workloads (the counterpart of
``repro/launch/workloads.py``).

The JAX builder is abstract: it returns ``ShapeDtypeStruct`` stand-ins
and mesh shardings for a dry-run lowering, and allocates nothing. This
is its concrete counterpart on one card: a :class:`Workload` holds the
function, real parameters from a seed and a real batch on the device,
ready to call as ``wl.fn(*wl.args)``, with the same batch keys, shapes
and dtypes and the same ``model_flops`` formulas.

Every (arch, shape) cell of the JAX registry builds (ROADMAP.md queue 1,
"Remaining workloads", items 3.1-3.5):

- LM (dense and MoE) at ``train_4k`` (one AdamW step of ``train_loss``),
  ``prefill_32k`` and ``decode_32k``; on one card the global batch is
  cut by ``batch=``;
- GraphSAGE at ``full_graph_sm``, ``minibatch_lg``, ``ogb_products``
  and ``molecule`` (one AdamW step each);
- every recsys kind (SASRec, MIND, BST, Wide&Deep) at ``train_batch``
  (one AdamW step), ``serve_p99``, ``serve_bulk`` and
  ``retrieval_cand``.

The JAX builder's dry-run analysis variants (``n_layers_override``,
``unroll``) and its shardings are XLA tooling (queue 4).
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
from dataclasses import dataclass
from typing import Any, Callable, Iterator, Tuple

import numpy as np
import torch

from repro_torch.configs import get_arch, get_shape
from repro_torch.configs.base import (GNNConfig, LMConfig, RecSysConfig,
                                      ShapeSpec)
from repro_torch.data.graph_data import (NeighborSampler, batched_molecules,
                                         synthetic_graph,
                                         synthetic_graph_without_csr)
from repro_torch.data.lm_data import synthetic_lm_batches
from repro_torch.data.recsys_data import recsys_batches
from repro_torch.device import batch_from_numpy, get_device
from repro_torch.models import gnn, recsys
from repro_torch.models import transformer as tr
from repro_torch.training import optimizer as opt

ADAMW = opt.AdamWConfig()


@dataclass
class Workload:
    name: str
    fn: Callable                  # positional args
    # (params, batch), or (params, opt_state, batch) for a train step;
    # tensors on the device
    args: Tuple[Any, ...]
    model_flops: float            # model-level useful flops of one call
    arch: str
    shape: str
    # further batches of the same shape from the same seeded stream, on
    # the device (``args`` holds the first)
    batches: Iterator[dict]


# ---------------------------------------------------------------------------
# LM workloads
# ---------------------------------------------------------------------------

def _lm_flops(cfg: LMConfig, shape: ShapeSpec) -> float:
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        return 2.0 * n_active * tokens
    # decode: one token per sequence + KV read has no flops
    return 2.0 * n_active * shape.global_batch


def build_lm(cfg: LMConfig, shape: ShapeSpec, device=None, seed: int = 0,
             batch: int | None = None) -> Workload:
    """Parameters from ``transformer.init_params`` with a generator
    ``gen`` on the device seeded by ``seed``; ``batch`` cuts the global
    batch B (the shape's by default), and ``model_flops`` counts the cut
    batch. By kind:

    - ``train``: ``fn`` is ``optimizer.make_train_step(train_loss,
      AdamWConfig())``, ``args`` (params, opt_state, batch) with
      {"tokens", "labels"} (B, S) int32 from ``synthetic_lm_batches(V,
      B, S, seed)``;
    - ``prefill``: ``fn(params, tokens)`` is ``transformer.prefill``;
      tokens (B, S) int32 drawn uniformly from ``gen``, anew for each
      batch (the numpy stream costs ~1 ms a draw on the host, seconds at
      S = 32,768);
    - ``decode``: ``fn(params, cache, token)`` is
      ``transformer.decode_step`` over a cache {"k", "v": (L, B, S, Kv,
      D) in ``cfg.dtype``, drawn from ``gen`` (standard normal);
      "length": (B,) int32 = S - 1}, token (B,) int32 from ``gen``, a
      new token for each batch. The step writes position S - 1 in
      place, so repeated calls read the same cache."""
    dev = get_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    B = shape.global_batch if batch is None else batch
    shape_b = dataclasses.replace(shape, global_batch=B)
    S, V = shape.seq_len, cfg.vocab_size
    params = tr.init_params(cfg, gen, dev)
    name = f"{cfg.name}:{shape.name}"
    flops = _lm_flops(cfg, shape_b)

    if shape.kind == "train":
        stream = (batch_from_numpy(b, dev)
                  for b in synthetic_lm_batches(V, B, S, seed))
        step = opt.make_train_step(
            lambda p, b: tr.train_loss(cfg, p, b), ADAMW)
        return Workload(name, step, (params, opt.init(params, ADAMW),
                                     next(stream)),
                        flops, cfg.name, shape.name, stream)

    def tokens(*size):
        while True:
            yield torch.randint(0, V, size, generator=gen, device=dev,
                                dtype=torch.int32)

    if shape.kind == "prefill":
        stream = tokens(B, S)

        def prefill_fn(p, toks):
            return tr.prefill(cfg, p, toks)
        return Workload(name, prefill_fn, (params, next(stream)), flops,
                        cfg.name, shape.name, stream)

    if shape.kind == "decode":
        dtype = getattr(torch, cfg.dtype)
        kv = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.head_dim)
        cache = {"k": torch.randn(kv, generator=gen, device=dev,
                                  dtype=dtype),
                 "v": torch.randn(kv, generator=gen, device=dev,
                                  dtype=dtype),
                 "length": torch.full((B,), S - 1, dtype=torch.int32,
                                      device=dev)}
        stream = tokens(B)

        def decode_fn(p, c, token):
            return tr.decode_step(cfg, p, c, token)
        return Workload(name, decode_fn, (params, cache, next(stream)),
                        flops, cfg.name, shape.name, stream)
    raise ValueError(shape.kind)


# ---------------------------------------------------------------------------
# GNN workloads
# ---------------------------------------------------------------------------

def _gnn_flops(cfg: GNNConfig, shape: ShapeSpec, d_feat: int) -> float:
    if shape.kind == "full_graph":
        N = shape.n_nodes
        # gradient flops ~ 3x fwd; fwd ~ 2*E*d_in (gather+scatter has no
        # flops) + matmuls N*(d_in*d + d*d) per layer
        fwd = 2 * N * (d_feat * cfg.d_hidden * 2) \
            + 2 * N * (cfg.d_hidden * cfg.d_hidden * 2) * (cfg.n_layers - 1)
        return 3.0 * fwd
    if shape.kind == "minibatch":
        B = shape.batch_nodes
        f1, f2 = shape.fanout
        n_vec = B * (1 + f1 + f1 * f2)
        return 3.0 * 2 * n_vec * d_feat * cfg.d_hidden * 2
    G, Ng = shape.global_batch, shape.n_nodes
    return 3.0 * 2 * G * Ng * (
        d_feat * cfg.d_hidden * 2
        + cfg.d_hidden * cfg.d_hidden * 2 * (cfg.n_layers - 1))


def build_gnn(cfg: GNNConfig, shape: ShapeSpec, device=None,
              seed: int = 0) -> Workload:
    """Parameters from ``gnn.init_params`` (d_feat the shape's) with a
    generator on the device seeded by ``seed``; ``fn`` is
    ``optimizer.make_train_step(<kind>_loss, AdamWConfig())`` and
    ``args`` (params, opt_state, batch), the batch with the keys, shapes
    and dtypes of the JAX builder's abstract batch on one device. Labels
    are drawn in [0, cfg.n_classes). By kind:

    - ``full_graph``: ``synthetic_graph(N, ceil(E / N), d_feat,
      n_classes, seed)`` (without its CSR, which the step does not
      read) with its first E edges kept (the edges are i.i.d. draws, so
      a prefix keeps their distribution); one device
      needs no padding, so ``edge_mask`` and ``label_mask`` are all True
      and the reference's masked path runs. Every batch is the graph;
    - ``minibatch``: ``NeighborSampler(graph, shape.fanout,
      seed).batches(batch_nodes, seed)`` over ``synthetic_graph(N,
      ceil(E / N), d_feat, n_classes, seed)``;
    - ``batched_graphs``: ``batched_molecules(G, Ng, Eg, d_feat,
      n_classes, seed + i)`` for the i-th batch."""
    dev = get_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d_feat = shape.d_feat if shape.kind in ("full_graph", "batched_graphs") \
        else shape.d_feat or cfg.d_feat
    params = gnn.init_params(cfg, gen, dev, d_feat=d_feat)
    N, E = shape.n_nodes, shape.n_edges

    if shape.kind == "full_graph":
        g = synthetic_graph_without_csr(N, -(-E // N), d_feat,
                                        cfg.n_classes, seed)
        batch = batch_from_numpy(
            {"feats": g.feats, "edges": g.edges[:E],
             "edge_mask": np.ones(E, bool), "labels": g.labels,
             "label_mask": np.ones(N, bool)}, dev)
        del g
        loss = functools.partial(gnn.full_graph_loss, cfg)

        def graphs():
            while True:
                yield batch
        stream = graphs()
    elif shape.kind == "minibatch":
        g = synthetic_graph(N, -(-E // N), d_feat, cfg.n_classes, seed)
        sampler = NeighborSampler(g, shape.fanout, seed)
        stream = (batch_from_numpy(b, dev)
                  for b in sampler.batches(shape.batch_nodes, seed))
        loss = functools.partial(gnn.minibatch_loss, cfg)
    else:
        G, Ng, Eg = shape.global_batch, N, E
        stream = (batch_from_numpy(
            batched_molecules(G, Ng, Eg, d_feat, cfg.n_classes, seed + i),
            dev) for i in itertools.count())
        loss = functools.partial(gnn.batched_graphs_loss, cfg)
    step = opt.make_train_step(loss, ADAMW)
    return Workload(f"{cfg.name}:{shape.name}", step,
                    (params, opt.init(params, ADAMW), next(stream)),
                    _gnn_flops(cfg, shape, d_feat), cfg.name, shape.name,
                    stream)


# ---------------------------------------------------------------------------
# RecSys workloads
# ---------------------------------------------------------------------------

SERVE_SLATE = {"sasrec": 100, "mind": 100, "bst": 1, "wide_deep": 1}


def _recsys_flops(cfg: RecSysConfig, shape: ShapeSpec) -> float:
    d = cfg.embed_dim
    if cfg.kind in ("sasrec", "mind", "bst"):
        S = cfg.seq_len + (1 if cfg.kind == "bst" else 0)
        blocks = max(cfg.n_blocks, 1)
        per_ex = blocks * (8 * S * d * d + 4 * S * S * d) \
            + sum(a * b * 2 for a, b in zip(
                ((cfg.seq_len + 1) * d,) + tuple(cfg.mlp_dims),
                tuple(cfg.mlp_dims) + (1,))) * (cfg.kind == "bst")
        if cfg.kind == "mind":
            per_ex = cfg.capsule_iters * 4 * S * cfg.n_interests * d \
                + 2 * S * d * d
    else:
        dims = (cfg.n_sparse * d,) + tuple(cfg.mlp_dims) + (1,)
        per_ex = sum(a * b * 2 for a, b in zip(dims[:-1], dims[1:]))
    if shape.kind == "train":
        return 3.0 * per_ex * shape.global_batch
    if shape.kind == "serve":
        slate = SERVE_SLATE[cfg.kind]
        mult = slate if cfg.kind == "bst" else 1
        return per_ex * shape.global_batch * mult
    # retrieval: encode once + dot against all candidates
    return per_ex + 2.0 * shape.n_candidates * cfg.embed_dim


def _input_keys(cfg: RecSysConfig, kind: str) -> Tuple[str, ...]:
    """The keys of ``recsys_batches`` that the JAX package's abstract
    batch (``_recsys_batch``) holds for a shape of ``kind``: the model's
    inputs, and for ``train`` its targets too."""
    if kind == "train":
        return {"sasrec": ("seq", "pos", "neg"),
                "mind": ("seq", "pos", "neg"),
                "bst": ("seq", "target", "label"),
                "wide_deep": ("sparse_ids", "sparse_mask", "label")}[cfg.kind]
    return ("sparse_ids", "sparse_mask") if cfg.kind == "wide_deep" \
        else ("seq",)


def build_recsys(cfg: RecSysConfig, shape: ShapeSpec, device=None,
                 seed: int = 0) -> Workload:
    """Parameters from ``recsys.init_params`` with a generator ``gen`` on
    the device seeded by ``seed``; batches of ``shape.global_batch`` rows
    from ``recsys_batches(cfg, B, seed)`` with the keys the JAX package's
    abstract batch has. Besides:

    - ``train``: ``fn`` is ``optimizer.make_train_step(train_loss,
      AdamWConfig())`` and ``args`` are (params, opt_state, batch), the
      state from ``optimizer.init``;
    - ``serve`` (SASRec, MIND, BST): ``cands`` (B, ``SERVE_SLATE[kind]``)
      int32, drawn uniformly in [1, n_items] by ``torch.randint`` from
      ``gen`` (after the parameters), anew for each batch;
    - ``retrieval``: ``cand_ids``, a permutation of the item ids
      1..n_items drawn from ``gen`` (repeated to ``shape.n_candidates``
      when that is larger, as in a smoke config), the same in every
      batch."""
    dev = get_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = recsys.init_params(cfg, gen, dev)
    keys = _input_keys(cfg, shape.kind)
    slate = SERVE_SLATE[cfg.kind] \
        if shape.kind == "serve" and cfg.kind != "wide_deep" else 0
    cand_ids = None
    if shape.kind == "retrieval":
        n = shape.n_candidates
        perm = torch.randperm(cfg.n_items, generator=gen, device=dev) + 1
        cand_ids = perm.repeat(-(-n // cfg.n_items))[:n] \
            .to(torch.int32).contiguous()

    def batches():
        for b in recsys_batches(cfg, shape.global_batch, seed):
            out = batch_from_numpy({k: b[k] for k in keys}, dev)
            if slate:
                out["cands"] = torch.randint(
                    1, cfg.n_items + 1, (shape.global_batch, slate),
                    generator=gen, device=dev, dtype=torch.int32)
            if cand_ids is not None:
                out["cand_ids"] = cand_ids
            yield out

    stream = batches()
    name = f"{cfg.name}:{shape.name}"
    flops = _recsys_flops(cfg, shape)
    if shape.kind == "train":
        step = opt.make_train_step(
            lambda p, b: recsys.train_loss(cfg, p, b), ADAMW)
        return Workload(name, step, (params, opt.init(params, ADAMW),
                                     next(stream)),
                        flops, cfg.name, shape.name, stream)
    if shape.kind == "serve":
        def fn(p, b):
            return recsys.serve_scores(cfg, p, b)
    else:
        def fn(p, b):
            return recsys.retrieval(cfg, p, b, k=100)
    return Workload(name, fn, (params, next(stream)), flops, cfg.name,
                    shape.name, stream)


# ---------------------------------------------------------------------------
# entry
# ---------------------------------------------------------------------------

def build_workload(arch_id: str, shape_name: str, device=None,
                   seed: int = 0, batch: int | None = None) -> Workload:
    """The concrete workload of one (arch, shape) cell on ``device``
    (default ``cuda``); ``batch`` cuts an LM shape's global batch. An
    arch or shape the registry lacks raises ``KeyError``."""
    cfg = get_arch(arch_id)
    shape = get_shape(cfg, shape_name)
    if isinstance(cfg, LMConfig):
        return build_lm(cfg, shape, device, seed, batch)
    if batch is not None:
        raise ValueError(f"{arch_id}: batch= cuts an LM shape only")
    if isinstance(cfg, GNNConfig):
        return build_gnn(cfg, shape, device, seed)
    return build_recsys(cfg, shape, device, seed)


__all__ = ["ADAMW", "SERVE_SLATE", "Workload", "build_gnn", "build_lm",
           "build_recsys", "build_workload"]
