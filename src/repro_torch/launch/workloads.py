"""Concrete single-card workloads (the counterpart of
``repro/launch/workloads.py``).

The JAX builder is abstract: it returns ``ShapeDtypeStruct`` stand-ins
and mesh shardings for a dry-run lowering, and allocates nothing. This
is its concrete counterpart on one card: a :class:`Workload` holds the
function, real parameters from a seed and a real batch on the device,
ready to call as ``wl.fn(*wl.args)``, with the same batch keys, shapes
and dtypes and the same ``model_flops`` formulas. On ``device="meta"``
it is abstract as the JAX builder is: parameters, AdamW state and the
batch are meta tensors at the shape's full global batch (no host data,
no host graph), and ``launch/dryrun.py`` counts a call under
``analysis.counter.ProgramCounter``.

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

The JAX builder's dry-run analysis variants are taken too:
``n_layers_override`` cuts an LM's layers as the reference does;
``unroll`` is kept for the signature and changes nothing else (the
port's layers are a Python loop, so a counter sees every layer).

With ``mesh=`` (a ``DeviceMesh``, ``launch/mesh.py``) the builders
place parameters, AdamW state and batches as DTensors by the
reference's specs (``distributed/sharding.py``; its ``_shard_tree`` and
``in_shardings``), run the call under ``use_dp_axes(dp, mesh=mesh)`` as
the reference does, and leave its outputs placed by its
``out_shardings``; each ``Workload`` records both as trees of
``NamedSharding``. The global batch is the shape's (or ``batch=``); a
full graph's edges are padded with masked edges to a multiple of the
mesh size, as the reference pads them. On ``device="meta"`` the
DTensors wrap meta shards of the per-rank shape, so a 256-rank cell is
counted on one host (``launch/dryrun.py --mesh single``).
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
from dataclasses import dataclass
from typing import Any, Callable, Iterator, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs import get_arch, get_shape
from repro_torch.configs.base import (GNNConfig, LMConfig, RecSysConfig,
                                      ShapeSpec)
from repro_torch.data.graph_data import (NeighborSampler, batched_molecules,
                                         synthetic_graph,
                                         synthetic_graph_without_csr)
from repro_torch.data.lm_data import synthetic_lm_batches
from repro_torch.data.recsys_data import recsys_batches
from repro_torch.device import batch_from_numpy, get_device
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.act_sharding import use_dp_axes
from repro_torch.launch.mesh import dp_axes
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
    # the device (``args`` holds the first; on meta the same batch)
    batches: Iterator[dict]
    # bytes a layer keeps for the backward (remat: the layer input), 0
    # outside LM training; and the layers that keep them
    residual_bytes_per_layer: float = 0.0
    n_loop_layers: int = 0
    # the dtype whose peak the roofline's compute term divides by
    compute_dtype: str = "float32"
    # on a mesh: the placements of ``args`` and of the call's output,
    # trees of ``sharding.NamedSharding`` (None on one device)
    in_shardings: Any = None
    out_shardings: Any = None


def _generator(dev: torch.device, seed: int) -> torch.Generator:
    """A generator for ``dev`` seeded by ``seed``; on meta (which has
    none) a CPU generator, which meta factories accept and never draw
    from."""
    return torch.Generator(device="cpu" if dev.type == "meta" else dev) \
        .manual_seed(seed)


def _repeat(batch: dict) -> Iterator[dict]:
    while True:
        yield batch


def _on_mesh(wl: Workload, mesh, arg_specs: tuple, out_specs,
             with_mesh: bool = True) -> Workload:
    """``wl`` with its args and batches placed on ``mesh`` by
    ``arg_specs`` (the last one the batch's), its call run under
    ``use_dp_axes(dp, mesh=mesh)`` (``mesh=None`` in the context when
    ``with_mesh`` is false, as the reference's decode does) and its
    output redistributed to ``out_specs``."""
    if mesh is None:
        return wl
    dp = dp_axes(mesh)
    args = tuple(shd.distribute_tree(a, mesh, s)
                 for a, s in zip(wl.args, arg_specs))
    b_spec = arg_specs[-1]
    inner = wl.fn

    def fn(*a):
        with use_dp_axes(dp, mesh=mesh if with_mesh else None):
            out = inner(*a)
        return _place(out, mesh, out_specs)
    stream = wl.batches
    return dataclasses.replace(
        wl, fn=fn, args=args,
        batches=(shd.distribute_tree(b, mesh, b_spec) for b in stream),
        in_shardings=shd.tree_shardings(mesh, arg_specs),
        out_shardings=shd.tree_shardings(mesh, out_specs))


def _place(out, mesh, specs):
    """Redistribute every DTensor of ``out`` to the matching spec."""
    if isinstance(specs, shd.P):
        if isinstance(out, DTensor):
            want = shd.placements(mesh, specs)
            if list(out.placements) != want:
                return out.redistribute(mesh, want)
        return out
    if isinstance(out, dict):
        return {k: _place(out[k], mesh, specs[k]) for k in out}
    return type(out)(_place(o, mesh, s) for o, s in zip(out, specs))


def _empty(dev, dtype, *shape) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=dev)


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
             batch: int | None = None, mesh=None) -> Workload:
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
      place, so repeated calls read the same cache.

    On meta every tensor is empty: tokens, labels, the cache and its
    lengths (S - 1) have the shapes and dtypes above, and ``batches``
    repeats the one batch. A train workload records the remat carry a
    layer, B S d_model in ``cfg.dtype`` (the reference's on one card;
    on a mesh the rank's share, divided by the DP ranks and, with
    sequence-parallel residuals, by 'model' too).

    On a ``mesh`` the params and AdamW state follow ``lm_param_specs``,
    the batch ``lm_batch_spec``, the cache ``lm_cache_spec`` and the
    token P(dp); the outputs the reference's (metrics replicated;
    prefill's ``lm_prefill_out_spec``; decode's logits P(dp, 'model')
    and the cache)."""
    dev = get_device(device)
    meta = dev.type == "meta"
    gen = _generator(dev, seed)
    B = shape.global_batch if batch is None else batch
    shape_b = dataclasses.replace(shape, global_batch=B)
    S, V = shape.seq_len, cfg.vocab_size
    params = tr.init_params(cfg, gen, dev)
    name = f"{cfg.name}:{shape.name}"
    flops = _lm_flops(cfg, shape_b)

    if shape.kind == "train":
        if meta:
            stream = _repeat({"tokens": _empty(dev, torch.int32, B, S),
                              "labels": _empty(dev, torch.int32, B, S)})
        else:
            stream = (batch_from_numpy(b, dev)
                      for b in synthetic_lm_batches(V, B, S, seed))
        step = opt.make_train_step(
            lambda p, b: tr.train_loss(cfg, p, b), ADAMW)
        carry = B * S * cfg.d_model * getattr(torch, cfg.dtype).itemsize
        if mesh is not None:
            n_dp = 1
            for a in dp_axes(mesh):
                n_dp *= mesh.size(mesh.mesh_dim_names.index(a))
            carry //= n_dp
            if cfg.seq_parallel and S % 16 == 0:
                carry //= mesh.size(mesh.mesh_dim_names.index("model"))
        wl = Workload(name, step, (params, opt.init(params, ADAMW),
                                   next(stream)),
                      flops, cfg.name, shape.name, stream,
                      residual_bytes_per_layer=float(carry),
                      n_loop_layers=cfg.n_layers,
                      compute_dtype=cfg.dtype)
        if mesh is None:
            return wl
        p_spec = shd.lm_param_specs(cfg)
        return _on_mesh(wl, mesh, (p_spec, shd.opt_specs(p_spec),
                                   shd.lm_batch_spec(mesh)),
                        (p_spec, shd.opt_specs(p_spec),
                         {"loss": shd.P(), "grad_norm": shd.P()}))

    def tokens(*size):
        while True:
            yield _empty(dev, torch.int32, *size) if meta else \
                torch.randint(0, V, size, generator=gen, device=dev,
                              dtype=torch.int32)

    if shape.kind == "prefill":
        stream = tokens(B, S)

        def prefill_fn(p, toks):
            return tr.prefill(cfg, p, toks)
        wl = Workload(name, prefill_fn, (params, next(stream)), flops,
                      cfg.name, shape.name, stream, compute_dtype=cfg.dtype)
        if mesh is None:
            return wl
        return _on_mesh(wl, mesh, (shd.lm_param_specs(cfg),
                                   shd.P(dp_axes(mesh), None)),
                        shd.lm_prefill_out_spec(mesh))

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
        wl = Workload(name, decode_fn, (params, cache, next(stream)),
                      flops, cfg.name, shape.name, stream,
                      compute_dtype=cfg.dtype)
        if mesh is None:
            return wl
        dp = dp_axes(mesh)
        c_spec = shd.lm_cache_spec(mesh)
        return _on_mesh(wl, mesh, (shd.lm_param_specs(cfg), c_spec,
                                   shd.P(dp)),
                        (shd.P(dp, "model"), c_spec), with_mesh=False)
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


_GNN_LOSSES = {"full_graph": gnn.full_graph_loss,
               "minibatch": gnn.minibatch_loss,
               "batched_graphs": gnn.batched_graphs_loss}


def build_gnn(cfg: GNNConfig, shape: ShapeSpec, device=None,
              seed: int = 0, mesh=None) -> Workload:
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
      n_classes, seed + i)`` for the i-th batch.

    On meta no graph is built on the host: the batch is empty meta
    tensors with the JAX builder's keys, shapes and dtypes (edges int32,
    masks bool, labels int32, features fp32), repeated.

    On a ``mesh`` the weights and AdamW state are replicated and the
    batch follows the reference's spec: a full graph's E edges (padded
    with masked edges to a multiple of the mesh size) over every axis,
    the rest over the DP axes."""
    dev = get_device(device)
    gen = _generator(dev, seed)
    d_feat = shape.d_feat if shape.kind in ("full_graph", "batched_graphs") \
        else shape.d_feat or cfg.d_feat
    params = gnn.init_params(cfg, gen, dev, d_feat=d_feat)
    N, E = shape.n_nodes, shape.n_edges
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    # the reference pads a full graph's edges to the mesh size
    E_pad = -(-E // mesh.size()) * mesh.size() \
        if mesh is not None and shape.kind == "full_graph" else E

    if dev.type == "meta":
        if shape.kind == "full_graph":
            batch = {"feats": _empty(dev, f32, N, d_feat),
                     "edges": _empty(dev, i32, E_pad, 2),
                     "edge_mask": _empty(dev, b8, E_pad),
                     "labels": _empty(dev, i32, N),
                     "label_mask": _empty(dev, b8, N)}
        elif shape.kind == "minibatch":
            B, (f1, f2) = shape.batch_nodes, shape.fanout
            batch = {"feat_l0": _empty(dev, f32, B, d_feat),
                     "feat_l1": _empty(dev, f32, B, f1, d_feat),
                     "feat_l2": _empty(dev, f32, B, f1, f2, d_feat),
                     "labels": _empty(dev, i32, B)}
        else:
            G = shape.global_batch
            batch = {"feats": _empty(dev, f32, G, N, d_feat),
                     "edges": _empty(dev, i32, G, E, 2),
                     "edge_mask": _empty(dev, b8, G, E),
                     "labels": _empty(dev, i32, G)}
        stream = _repeat(batch)
    elif shape.kind == "full_graph":
        g = synthetic_graph_without_csr(N, -(-E // N), d_feat,
                                        cfg.n_classes, seed)
        pad = E_pad - E
        batch = batch_from_numpy(
            {"feats": g.feats,
             "edges": np.concatenate([g.edges[:E],
                                      np.zeros((pad, 2), np.int32)]),
             "edge_mask": np.arange(E_pad) < E, "labels": g.labels,
             "label_mask": np.ones(N, bool)}, dev)
        del g
        stream = _repeat(batch)
    elif shape.kind == "minibatch":
        g = synthetic_graph(N, -(-E // N), d_feat, cfg.n_classes, seed)
        sampler = NeighborSampler(g, shape.fanout, seed)
        stream = (batch_from_numpy(b, dev)
                  for b in sampler.batches(shape.batch_nodes, seed))
    else:
        G, Ng, Eg = shape.global_batch, N, E
        stream = (batch_from_numpy(
            batched_molecules(G, Ng, Eg, d_feat, cfg.n_classes, seed + i),
            dev) for i in itertools.count())
    loss = functools.partial(_GNN_LOSSES[shape.kind], cfg)
    step = opt.make_train_step(loss, ADAMW)
    wl = Workload(f"{cfg.name}:{shape.name}", step,
                  (params, opt.init(params, ADAMW), next(stream)),
                  _gnn_flops(cfg, shape, d_feat), cfg.name, shape.name,
                  stream, compute_dtype=cfg.dtype)
    if mesh is None:
        return wl
    p_spec = shd.gnn_param_specs(cfg, params)
    b_spec = shd.gnn_batch_spec(mesh, shape.kind)
    if shape.kind == "full_graph":
        b_spec["edge_mask"] = shd.P(tuple(mesh.mesh_dim_names))
    return _on_mesh(wl, mesh, (p_spec, shd.opt_specs(p_spec), b_spec),
                    (p_spec, shd.opt_specs(p_spec),
                     {"loss": shd.P(), "grad_norm": shd.P()}))


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


def _meta_batch(cfg: RecSysConfig, keys, B: int, dev) -> dict:
    """Empty meta tensors for ``keys`` with the shapes and dtypes of
    ``recsys_batches``' arrays at batch B."""
    L, i32 = cfg.seq_len, torch.int32
    shapes = {"sparse_ids": ((B, cfg.n_sparse, cfg.multi_hot), i32),
              "sparse_mask": ((B, cfg.n_sparse, cfg.multi_hot), torch.bool),
              "label": ((B,), torch.float32), "seq": ((B, L), i32),
              "target": ((B,), i32),
              "pos": ((B, L) if cfg.kind == "sasrec" else (B,), i32),
              "neg": ((B, L) if cfg.kind == "sasrec" else (B, 16), i32)}
    return {k: _empty(dev, shapes[k][1], *shapes[k][0]) for k in keys}


def build_recsys(cfg: RecSysConfig, shape: ShapeSpec, device=None,
                 seed: int = 0, mesh=None) -> Workload:
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
      batch.

    On meta every batch tensor is empty with those shapes and dtypes,
    and ``batches`` repeats the one batch.

    On a ``mesh`` the params follow ``recsys_param_specs`` (tables of >=
    4096 rows over 'model'), the batch ``recsys_batch_spec``; the
    outputs the reference's (metrics replicated, serve scores P(dp,
    None), retrieval's (scores, ids) replicated, merged from per-rank
    top-k lists)."""
    dev = get_device(device)
    gen = _generator(dev, seed)
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

    if dev.type == "meta":
        b = _meta_batch(cfg, keys, shape.global_batch, dev)
        if slate:
            b["cands"] = _empty(dev, torch.int32, shape.global_batch, slate)
        if cand_ids is not None:
            b["cand_ids"] = cand_ids
        stream = _repeat(b)
    else:
        stream = batches()
    name = f"{cfg.name}:{shape.name}"
    flops = _recsys_flops(cfg, shape)
    if mesh is not None:
        p_spec = shd.recsys_param_specs(cfg, params)
        b_full = shd.recsys_batch_spec(mesh, cfg, shape.kind)
        b_spec = {k: b_full[k] for k in keys + (("cands",) if slate else ())
                  + (("cand_ids",) if cand_ids is not None else ())}
    if shape.kind == "train":
        step = opt.make_train_step(
            lambda p, b: recsys.train_loss(cfg, p, b), ADAMW)
        wl = Workload(name, step, (params, opt.init(params, ADAMW),
                                   next(stream)),
                      flops, cfg.name, shape.name, stream,
                      compute_dtype=cfg.dtype)
        if mesh is None:
            return wl
        return _on_mesh(wl, mesh, (p_spec, shd.opt_specs(p_spec), b_spec),
                        (p_spec, shd.opt_specs(p_spec),
                         {"loss": shd.P(), "grad_norm": shd.P()}))
    if shape.kind == "serve":
        def fn(p, b):
            return recsys.serve_scores(cfg, p, b)
        out = shd.P(dp_axes(mesh), None) if mesh is not None else None
    else:
        def fn(p, b):
            return recsys.retrieval(cfg, p, b, k=100)
        out = (shd.P(None, None), shd.P(None, None))
    wl = Workload(name, fn, (params, next(stream)), flops, cfg.name,
                  shape.name, stream, compute_dtype=cfg.dtype)
    if mesh is None:
        return wl
    return _on_mesh(wl, mesh, (p_spec, b_spec), out)


# ---------------------------------------------------------------------------
# entry
# ---------------------------------------------------------------------------

def build_workload(arch_id: str, shape_name: str, device=None,
                   seed: int = 0, batch: int | None = None,
                   n_layers_override: int | None = None,
                   unroll: bool = False, mesh=None) -> Workload:
    """The workload of one (arch, shape) cell on ``device`` (default
    ``cuda``; ``meta`` for the dry run); ``batch`` cuts an LM shape's
    global batch. ``n_layers_override`` builds an LM with that many
    layers, as the reference's analysis variants do (other kinds ignore
    it, as there). ``unroll`` is accepted for the reference's signature
    and ignored: the reference unrolls its ``lax.scan`` over the layers
    so that XLA counts each; the port's layers are a Python loop, which
    a counter sees whole. ``mesh`` (a ``DeviceMesh``) places the cell
    as the reference's sharded builder does (see the module docstring);
    ``device`` is then where each rank's shards live (its card, ``cpu``
    for gloo, ``meta`` for a counted dry run). An arch or shape the
    registry lacks raises ``KeyError``."""
    cfg = get_arch(arch_id)
    shape = get_shape(cfg, shape_name)
    if isinstance(cfg, LMConfig):
        if n_layers_override is not None:
            cfg = dataclasses.replace(cfg, n_layers=n_layers_override)
        return build_lm(cfg, shape, device, seed, batch, mesh)
    if batch is not None:
        raise ValueError(f"{arch_id}: batch= cuts an LM shape only")
    if isinstance(cfg, GNNConfig):
        return build_gnn(cfg, shape, device, seed, mesh)
    return build_recsys(cfg, shape, device, seed, mesh)


__all__ = ["ADAMW", "SERVE_SLATE", "Workload", "build_gnn", "build_lm",
           "build_recsys", "build_workload"]
