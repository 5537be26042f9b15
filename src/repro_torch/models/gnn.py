"""GraphSAGE with gather -> segment-reduce message passing (port of
``repro/models/gnn.py``).

Three compute regimes (matching the assigned shape set):

- full-graph:     edge-index scatter aggregation over the whole graph
                  (full_graph_sm / ogb_products)
- minibatch:      sampled neighborhoods from the host-side neighbor sampler
                  (minibatch_lg, fanout e.g. 15-10) — dense gathered tensors
- batched graphs: many small padded graphs (molecule)

Message passing is ``h[src]`` then a segment reduction into ``dst``:
``index_add_`` for the sum and the mean (the reference's
``segment_sum``; :class:`GatherSum`, whose backward is the transposed
pair, so autograd keeps no (E, F) message tensor between the passes),
``scatter_reduce(..., "amax")`` into ``-inf`` for the max, so an empty
segment holds ``-inf`` as JAX's ``segment_max`` gives.
The batches hold int32 edges; they are widened to int64 once a forward.
On CUDA the segment sums add by atomics, in another order than the
CPU's. The reference's gather and ``segment_sum`` are XLA ops, not a
TPU kernel, so no hand-written kernel is on this path.

On a mesh (DTensor params and batch, ``distributed/sharding.py``): a
full graph's edges are sharded over every axis and its features
replicated, each rank aggregates its edges and the sums are summed over
all axes (the max: each rank's maxima are maxed over all axes, and a
maximum's gradient is shared by its ties on every rank, as
``segment_max`` shares it); a batch of small graphs is split by whole
graphs over the DP axes; minibatch features are batch-sharded and run
by DTensor.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import Partial, Replicate

from repro_torch.configs.base import GNNConfig
from repro_torch.device import get_device
from repro_torch.distributed.act_sharding import (
    all_reduce_over, dp_placements, from_local, local_of, local_weight,
    replicated)
from repro_torch.models.layers import dense_init
from repro_torch.tree import tree_map

Params = Dict[str, Any]


def init_params(cfg: GNNConfig, generator: torch.Generator | None = None,
                device=None, d_feat: int | None = None) -> Params:
    """Weights for n_layers SAGE layers + linear classifier head, in
    ``cfg.dtype`` on ``device`` (default ``cuda``), drawn by
    ``layers.dense_init`` from ``generator`` (seed 0 by default) in the
    reference's order; the draws differ from JAX's."""
    dev = get_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    d_in = d_feat if d_feat is not None else cfg.d_feat
    dtype = getattr(torch, cfg.dtype)
    params: Params = {"layers": []}
    for _ in range(cfg.n_layers):
        d_out = cfg.d_hidden
        params["layers"].append({
            "w_self": dense_init((d_in, d_out), dtype, generator, dev),
            "w_neigh": dense_init((d_in, d_out), dtype, generator, dev),
            "bias": torch.zeros((d_out,), dtype=dtype, device=dev),
        })
        d_in = d_out
    params["head"] = dense_init((cfg.d_hidden, cfg.n_classes), dtype,
                                generator, dev)
    return params


def params_from_numpy(cfg: GNNConfig, tree, device=None) -> Params:
    """The port's parameters from the JAX parameter tree given as numpy
    arrays (``{"layers": [{"w_self", "w_neigh", "bias"}], "head"}``), in
    ``cfg.dtype``."""
    dev = get_device(device)
    dtype = getattr(torch, cfg.dtype)

    def conv(a):
        return torch.tensor(np.asarray(a)).to(device=dev, dtype=dtype)
    return {"layers": [{k: conv(p[k]) for k in ("w_self", "w_neigh", "bias")}
                       for p in tree["layers"]],
            "head": conv(tree["head"])}


class GatherSum(torch.autograd.Function):
    """``segment_sum(feats[src], dst, n)``: the gather and the segment
    sum in one autograd node. Autograd's own ``index_add_`` saves its
    (E, F) source for the backward (``ogb_products``' layer 2: 31.7 GB);
    this saves only the indices. Backward: ``grad[dst]`` summed into
    ``src`` by ``index_add_``, the two ops transposed."""

    @staticmethod
    def forward(ctx, feats, src, dst, n_segments: int):
        ctx.save_for_backward(src, dst)
        ctx.n_rows = feats.shape[0]
        return feats.new_zeros((n_segments, feats.shape[1])).index_add_(
            0, dst, feats[src])

    @staticmethod
    def backward(ctx, grad):
        src, dst = ctx.saved_tensors
        g = grad.new_zeros((ctx.n_rows, grad.shape[1])).index_add_(
            0, src, grad[dst])
        return g, None, None, None


def edge_sums(feats, src, dst, n_nodes: int):
    """``segment_sum`` of the messages ``feats[src]`` into ``dst`` and of
    the edge counts (the mean's degrees): the whole aggregation on one
    device, one rank's share of it on a mesh."""
    summed = GatherSum.apply(feats, src, dst, n_nodes)
    deg = feats.new_zeros((n_nodes,)).index_add_(
        0, dst, torch.ones_like(dst, dtype=feats.dtype))
    return summed, deg


def _edge_local_sums(feats, src, dst, n_nodes: int):
    """On a mesh (the edges sharded over every axis, the features
    replicated): each rank sums its own edges, ``segment_sum`` of its
    messages and of its edge counts, and both are Partial over every
    axis, so they are summed over all ranks where next redistributed."""
    mesh = src.device_mesh
    rep = [Replicate()] * mesh.ndim
    part = [Partial()] * mesh.ndim
    f_l = feats.redistribute(mesh, rep).to_local(grad_placements=part)
    summed, deg = edge_sums(f_l, src.to_local(), dst.to_local(), n_nodes)
    return (from_local(summed, mesh, part, (n_nodes, f_l.shape[1])),
            from_local(deg, mesh, part, (n_nodes,)))


def _segment_amax(msgs, dst, n_segments: int):
    """``segment_max(msgs, dst, n_segments)``: ``amax`` of the rows of
    ``msgs`` into their ``dst`` segments, ``-inf`` where a segment gets
    none."""
    width = msgs.shape[1]
    return torch.full((n_segments, width), float("-inf"), dtype=msgs.dtype,
                      device=msgs.device).scatter_reduce(
        0, dst[:, None].expand(-1, width), msgs, "amax", include_self=False)


class EdgeMax(torch.autograd.Function):
    """``segment_max(feats[src], dst, n)`` over edges sharded across the
    ranks of ``mesh`` (``feats`` replicated, ``src``/``dst`` this rank's
    edges): each rank takes ``amax`` over its own edges into ``-inf``,
    and the maxima are maxed over all axes (an empty segment stays
    ``-inf``). The gradient of a maximum is split evenly among the
    edges that attain it, as ``segment_max`` and ``amax`` split it,
    with the ties counted on every rank (the counts summed over all
    axes): a maximum tied across two ranks gives each tie half, not
    each rank the whole. Backward: this rank's share of the features'
    gradient (summed over the ranks by the caller's Partial
    placement). Saves the indices, the features, the maxima and the
    tie counts; the (E, F) ties are recomputed."""

    @staticmethod
    def forward(ctx, feats, src, dst, n_segments: int, mesh):
        msgs = feats[src]
        out = all_reduce_over(_segment_amax(msgs, dst, n_segments), mesh,
                              "max")
        ties = (msgs == out[dst]).to(feats.dtype)
        count = all_reduce_over(torch.zeros_like(out).index_add_(
            0, dst, ties), mesh, "sum")
        ctx.save_for_backward(feats, src, dst, out, count)
        return out

    @staticmethod
    def backward(ctx, grad):
        feats, src, dst, out, count = ctx.saved_tensors
        share = torch.where(feats[src] == out[dst],
                            grad[dst] / count.clamp(min=1.0)[dst], 0.0)
        return (torch.zeros_like(feats).index_add_(0, src, share), None,
                None, None, None)


def _edge_local_max(feats, src, dst, n_nodes: int):
    """On a mesh (the edges sharded over every axis, the features
    replicated): :class:`EdgeMax` on this rank's edges; the result is
    replicated, the features' gradient Partial over every axis."""
    mesh = src.device_mesh
    rep = [Replicate()] * mesh.ndim
    f_l = feats.redistribute(mesh, rep).to_local(
        grad_placements=[Partial()] * mesh.ndim)
    out = EdgeMax.apply(f_l, src.to_local(), dst.to_local(), n_nodes, mesh)
    return from_local(out, mesh, rep, (n_nodes, f_l.shape[1]))


def _aggregate(cfg: GNNConfig, feats: torch.Tensor, src: torch.Tensor,
               dst: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """Aggregate neighbor features along edges (src -> dst); ``src`` and
    ``dst`` int64. On a mesh (DTensor edges) each rank aggregates its
    own edges: the sums and degrees are summed over all axes, the
    maxima maxed over them (:class:`EdgeMax`)."""
    if hasattr(src, "device_mesh"):
        if cfg.aggregator == "max":
            return _edge_local_max(feats, src, dst, n_nodes)
        if cfg.aggregator not in ("mean", "sum"):
            raise ValueError(cfg.aggregator)
        summed, deg = _edge_local_sums(feats, src, dst, n_nodes)
        if cfg.aggregator == "sum":
            return summed
        return summed / torch.clamp(deg, min=1.0)[:, None]
    if cfg.aggregator == "mean":
        summed, deg = edge_sums(feats, src, dst, n_nodes)
        return summed / torch.clamp(deg, min=1.0)[:, None]
    if cfg.aggregator == "sum":
        return GatherSum.apply(feats, src, dst, n_nodes)
    if cfg.aggregator == "max":
        return _segment_amax(feats[src], dst, n_nodes)
    raise ValueError(cfg.aggregator)


def _sage_layer(cfg: GNNConfig, p: Params, h_self: torch.Tensor,
                h_agg: torch.Tensor, last: bool) -> torch.Tensor:
    out = h_self @ p["w_self"] + h_agg @ p["w_neigh"] + p["bias"]
    if not last:
        out = torch.relu(out)
        # L2-normalize, as in the GraphSAGE paper (Alg. 1 line 7)
        out = out / torch.clamp(
            torch.linalg.vector_norm(out, dim=-1, keepdim=True), min=1e-6)
    return out


def full_graph_forward(cfg: GNNConfig, params: Params, feats: torch.Tensor,
                       edges: torch.Tensor,
                       edge_mask: torch.Tensor | None = None) -> torch.Tensor:
    """feats (N, F), edges (E, 2) int32 [src, dst] -> logits (N, classes).

    ``edge_mask`` marks valid rows; masked edges route to a trash
    segment (row N of a zero-padded copy of the features)."""
    n = feats.shape[0]
    h = feats
    if edge_mask is None:
        src, dst = edges[:, 0].long(), edges[:, 1].long()
        segs = n
    else:
        src = torch.where(edge_mask, edges[:, 0], n).long()
        dst = torch.where(edge_mask, edges[:, 1], n).long()
        segs = n + 1
    for p in params["layers"]:
        if edge_mask is None:
            agg = _aggregate(cfg, h, src, dst, segs)
        else:
            hp = torch.cat([h, h.new_zeros((1, h.shape[1]))])
            agg = _aggregate(cfg, hp, src, dst, segs)[:n]
        h = _sage_layer(cfg, p, h, agg, last=False)
    return h @ params["head"]


def minibatch_forward(cfg: GNNConfig, params: Params,
                      feat_levels: list) -> torch.Tensor:
    """Sampled-neighborhood forward (GraphSAGE Algorithm 2).

    feat_levels[l]: features of nodes at sampling depth l, shape
    (B, f_1, ..., f_l, F): level 0 = the batch targets, level l>0 = their
    sampled neighbors (from the host neighbor sampler). The fanout mean is
    the dense analogue of the segment mean for a fixed fanout.
    """
    h = list(feat_levels)
    n_layers = len(params["layers"])
    for li, p in enumerate(params["layers"]):
        nxt = []
        for depth in range(n_layers - li):
            agg = h[depth + 1].mean(dim=-2)             # mean over fanout
            nxt.append(_sage_layer(cfg, p, h[depth], agg, last=False))
        h = nxt
    return h[0] @ params["head"]


def batched_graphs_forward(cfg: GNNConfig, params: Params,
                           feats: torch.Tensor, edges: torch.Tensor,
                           edge_mask: torch.Tensor) -> torch.Tensor:
    """Padded small-graph batch. feats (G, N, F), edges (G, E, 2),
    edge_mask (G, E) bool. Returns per-graph logits (G, classes).

    The reference maps one graph's pass over the batch (``jax.vmap``);
    here the G graphs run as one graph of G * (N + 1) segments: graph g's
    nodes and its trash segment (masked edges) are offset by g * (N + 1).
    The aggregation is the mean, whatever ``cfg.aggregator``, as in the
    reference."""
    if hasattr(feats, "device_mesh"):
        return _graphs_on_local_shards(cfg, params, feats, edges, edge_mask)
    G, n, _ = feats.shape
    off = (torch.arange(G, device=feats.device) * (n + 1))[:, None]
    src = (torch.where(edge_mask, edges[..., 0], n) + off).reshape(-1).long()
    dst = (torch.where(edge_mask, edges[..., 1], n) + off).reshape(-1).long()
    deg_w = edge_mask.reshape(-1).to(feats.dtype)
    h = feats
    for p in params["layers"]:
        width = h.shape[-1]
        msgs = torch.cat([h, h.new_zeros((G, 1, width))], 1) \
            .reshape(G * (n + 1), width)
        agg_sum = GatherSum.apply(msgs, src, dst, G * (n + 1))
        deg = h.new_zeros((G * (n + 1),)).index_add_(0, dst, deg_w)
        agg = (agg_sum / torch.clamp(deg, min=1.0)[:, None]) \
            .reshape(G, n + 1, width)[:, :n]
        h = _sage_layer(cfg, p, h, agg, last=False)
    return h.mean(dim=1) @ params["head"]               # mean readout


def _graphs_on_local_shards(cfg: GNNConfig, params: Params, feats, edges,
                            edge_mask):
    """:func:`batched_graphs_forward` of a batch sharded over the DP axes
    (whole graphs a rank): each rank runs its graphs with the replicated
    weights, whose gradients are its share (Partial over the DP axes)."""
    mesh = feats.device_mesh
    rows = dp_placements(mesh, 0)
    local = [t.redistribute(mesh, rows).to_local()
             for t in (feats, edges, edge_mask)]
    p_l = tree_map(local_weight, params)
    out = batched_graphs_forward(cfg, p_l, *local)
    return from_local(out, mesh, rows, (feats.shape[0], out.shape[-1]))


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _xent(logits: torch.Tensor, labels: torch.Tensor,
          mask=None) -> torch.Tensor:
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    if hasattr(logp, "device_mesh"):     # the gold class by a masked sum
        cls = replicated(torch.arange(logp.shape[-1],
                                      device=local_of(labels).device), logp)
        nll = -torch.where(cls == labels[..., None], logp, 0.0).sum(-1)
    else:
        nll = -torch.take_along_dim(logp, labels.long()[..., None],
                                    dim=-1)[..., 0]
    if mask is None:
        return nll.mean()
    mask = mask.to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp(mask.sum(), min=1.0)


def full_graph_loss(cfg: GNNConfig, params: Params, batch) -> torch.Tensor:
    logits = full_graph_forward(cfg, params, batch["feats"], batch["edges"],
                                batch.get("edge_mask"))
    return _xent(logits, batch["labels"], batch.get("label_mask"))


def minibatch_loss(cfg: GNNConfig, params: Params, batch) -> torch.Tensor:
    levels = [batch[f"feat_l{i}"] for i in range(cfg.n_layers + 1)]
    logits = minibatch_forward(cfg, params, levels)
    return _xent(logits, batch["labels"])


def batched_graphs_loss(cfg: GNNConfig, params: Params,
                        batch) -> torch.Tensor:
    logits = batched_graphs_forward(cfg, params, batch["feats"],
                                    batch["edges"], batch["edge_mask"])
    return _xent(logits, batch["labels"])
