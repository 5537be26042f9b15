"""RecSys models (port of ``repro/models/recsys.py``): Wide&Deep serving
and retrieval, plus EmbeddingBag.

Plain functions over a params dict, as in the JAX module:

    init_params(cfg, generator, device)      # random weights
    params_from_numpy(cfg, tree, device)     # the JAX parameter tree
    serve_scores(cfg, params, batch)         # 'serve_p99' / 'serve_bulk'
    user_repr(cfg, params, batch)            # query-side tower
    retrieval(cfg, params, batch, k)         # 'retrieval_cand'
    retrieval_sharded(cfg, params, batch, mesh, k)   # the same, sharded

The fixed-shape bag reduce goes through ``kernels/embedding_bag``: the
hand-written CUDA kernel on the card, its plain version on the CPU. The
JAX model computes it with ``jnp.take`` and a masked sum
(``recsys.py:59``) and never reaches its Pallas kernel. The port's mean
mode weighs each id by ``mask / max(count, 1)`` and sums, where the JAX
package sums ``mask * row`` and divides, so the two differ by ulps.

Only the ``wide_deep`` kind is ported. SASRec, MIND and BST, and every
``train_loss`` (which needs an embedding-bag backward), raise
``NotImplementedError`` (ROADMAP.md queue 1, "Remaining workloads").
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import RecSysConfig
from repro_torch.device import get_device
from repro_torch.index.flat import topk_scores
from repro_torch.kernels.embedding_bag.ops import embedding_bag as _bag
from repro_torch.models.layers import dense_init, embed_init

Params = Dict[str, Any]
PORTED_KINDS = ("wide_deep",)


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md queue 1, \"Remaining "
        "workloads\")")


def _check_kind(cfg: RecSysConfig) -> None:
    if cfg.kind not in PORTED_KINDS:
        raise _unported(f"recsys kind {cfg.kind!r}")


def _table_rows(n: int, mult: int = 2048) -> int:
    """Round table rows up so row-sharding divides any mesh axis."""
    return -(-n // mult) * mult


# ---------------------------------------------------------------------------
# EmbeddingBag
# ---------------------------------------------------------------------------

def embedding_bag_ragged(table: torch.Tensor, ids: torch.Tensor,
                         segment_ids: torch.Tensor, n_bags: int,
                         mode: str = "mean") -> torch.Tensor:
    """Ragged EmbeddingBag: gather + segment reduce.

    table (V, d); ids (T,) row indices; segment_ids (T,) sorted bag
    index. An empty bag gives 0 (sum, mean) or -inf (max), as
    ``jax.ops.segment_sum`` / ``segment_max``."""
    rows = table.index_select(0, ids.long())                # (T, d)
    seg = segment_ids.long()
    out = torch.zeros((n_bags, table.shape[1]), dtype=table.dtype,
                      device=table.device)
    if mode == "sum":
        return out.index_add_(0, seg, rows)
    if mode == "mean":
        cnt = torch.zeros((n_bags,), dtype=table.dtype, device=table.device)
        cnt.index_add_(0, seg, torch.ones_like(rows[:, 0]))
        return out.index_add_(0, seg, rows) \
            / torch.clamp(cnt, min=1.0)[:, None]
    if mode == "max":
        out.fill_(float("-inf"))
        return out.scatter_reduce_(0, seg[:, None].expand_as(rows), rows,
                                   reduce="amax", include_self=True)
    raise ValueError(mode)


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  mask: torch.Tensor | None = None,
                  mode: str = "mean") -> torch.Tensor:
    """Fixed-shape EmbeddingBag: ids (..., m) -> (..., d), masked reduce
    by one weighted-sum kernel call over the (prod(...), m) bags, with
    the second-last axis (Wide&Deep's fields) as the kernel's groups.
    Mean weighs each id ``mask / max(count, 1)`` (``1/m`` without a
    mask); sum weighs it ``mask`` (1 without a mask)."""
    m = ids.shape[-1]
    w = bag_weights(ids, mask, mode)
    groups = ids.shape[-2] if ids.dim() >= 3 else 1
    out = _bag(table, ids.reshape(-1, m), w.reshape(-1, m), groups)
    return out.reshape(*ids.shape[:-1], table.shape[1]).to(table.dtype)


def bag_weights(ids: torch.Tensor, mask: torch.Tensor | None,
                mode: str) -> torch.Tensor:
    """The (..., m) fp32 weights of :func:`embedding_bag`'s weighted sum
    for ``mode`` 'mean' or 'sum'."""
    if mode not in ("mean", "sum"):
        raise ValueError(mode)
    if mask is None:
        m = ids.shape[-1]
        return torch.full(ids.shape, 1.0 / m if mode == "mean" else 1.0,
                          dtype=torch.float32, device=ids.device)
    w = mask.to(torch.float32)
    if mode == "mean":
        w = w / torch.clamp(w.sum(-1, keepdim=True), min=1.0)
    return w


# ---------------------------------------------------------------------------
# shared small blocks
# ---------------------------------------------------------------------------

def _mlp_init(generator, dims, dtype, device):
    return [{"w": dense_init((a, b), dtype, generator, device),
             "b": torch.zeros((b,), dtype=dtype, device=device)}
            for a, b in zip(dims[:-1], dims[1:])]


def _mlp(ws, x, final_act=False):
    for i, l in enumerate(ws):
        x = x @ l["w"] + l["b"]
        if i < len(ws) - 1 or final_act:
            x = torch.relu(x)
    return x


# ---------------------------------------------------------------------------
# Wide&Deep  [arXiv:1606.07792]
# ---------------------------------------------------------------------------

def wide_deep_init(cfg: RecSysConfig, generator: torch.Generator,
                   device) -> Params:
    dtype = getattr(torch, cfg.dtype)
    d = cfg.embed_dim
    rows = _table_rows(cfg.n_sparse * cfg.sparse_vocab)
    return {
        # one big table: field f owns rows [f*V, (f+1)*V)
        "tables": embed_init((rows, d), dtype, generator, device)
        * d ** -0.5,
        "wide": torch.zeros((rows, 1), dtype=dtype, device=device),
        "mlp": _mlp_init(generator, (cfg.n_sparse * d, *cfg.mlp_dims, 1),
                         dtype, device),
        "user_proj": dense_init((cfg.mlp_dims[-1], d), dtype, generator,
                                device),
        "item_emb": embed_init((_table_rows(cfg.n_items + 1), d), dtype,
                               generator, device) * d ** -0.5,
    }


def _wd_field_ids(cfg, ids):
    """ids (B, n_sparse, m) local ids -> global rows in the fused table."""
    offs = torch.arange(cfg.n_sparse, dtype=ids.dtype, device=ids.device) \
        * cfg.sparse_vocab
    return ids + offs[None, :, None]


def wide_deep_logit(cfg: RecSysConfig, params: Params, batch):
    gids = _wd_field_ids(cfg, batch["sparse_ids"])       # (B, F, m)
    mask = batch.get("sparse_mask")
    bags = embedding_bag(params["tables"], gids, mask)   # (B, F, d)
    deep = _mlp(params["mlp"], bags.reshape(bags.shape[0], -1))[:, 0]
    wide = embedding_bag(params["wide"], gids, mask, mode="sum")
    return deep + wide.sum(dim=(1, 2))


def wide_deep_serve_scores(cfg, params, batch):
    return wide_deep_logit(cfg, params, batch)[:, None]


def wide_deep_user_repr(cfg, params, batch):
    gids = _wd_field_ids(cfg, batch["sparse_ids"])
    bags = embedding_bag(params["tables"], gids, batch.get("sparse_mask"))
    x = bags.reshape(bags.shape[0], -1)
    for l in params["mlp"][:-1]:
        x = torch.relu(x @ l["w"] + l["b"])
    return x @ params["user_proj"]


# ---------------------------------------------------------------------------
# retrieval: 1 query vs n_candidates, top-k
# ---------------------------------------------------------------------------

def retrieval(cfg: RecSysConfig, params: Params, batch, k: int = 100):
    """Score the user repr against a large candidate set by raw dot
    (``index/flat.topk_scores``: a matmul and a top-k with ties to the
    lowest candidate position); returns (scores (B, k), ids (B, k))."""
    u = user_repr(cfg, params, batch)
    cand = params["item_emb"][batch["cand_ids"].long()]
    return topk_scores(u, cand, batch["cand_ids"], k)


def user_repr(cfg: RecSysConfig, params: Params, batch):
    _check_kind(cfg)
    return wide_deep_user_repr(cfg, params, batch)


def retrieval_sharded(cfg: RecSysConfig, params: Params, batch, mesh,
                      k: int = 100):
    """Retrieval with the item table row-sharded over ``mesh`` and
    range-partitioned candidates (``batch["cand_ids"]`` split into equal
    blocks, block ``s`` holding ids of shard ``s``'s rows): the gather
    and the top-k run a shard, and only k candidates a shard reach the
    merge (``index/sharded.sharded_topk_local_candidates``). Returns
    (scores (B, k), ids (B, k)), those of :func:`retrieval` on such a
    candidate list."""
    from repro_torch.index.sharded import sharded_topk_local_candidates
    u = user_repr(cfg, params, batch)
    return sharded_topk_local_candidates(
        u, params["item_emb"], batch["cand_ids"], mesh, k=k)


def init_params(cfg: RecSysConfig, generator: torch.Generator | None = None,
                device=None) -> Params:
    """Random weights in ``cfg.dtype`` on ``device`` (default ``cuda``),
    with the distributions of the JAX ``init_params``; ``generator``
    (on that device) defaults to seed 0."""
    _check_kind(cfg)
    dev = get_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return wide_deep_init(cfg, generator, dev)


def params_from_numpy(cfg: RecSysConfig, tree, device=None) -> Params:
    """The port's parameters from the JAX parameter tree given as numpy
    arrays (same keys: ``tables``, ``wide``, ``mlp[i].w/b``,
    ``user_proj``, ``item_emb``), in ``cfg.dtype``."""
    _check_kind(cfg)
    dev = get_device(device)
    dtype = getattr(torch, cfg.dtype)

    def conv(a):
        return torch.tensor(np.asarray(a)).to(device=dev, dtype=dtype)
    return {"tables": conv(tree["tables"]), "wide": conv(tree["wide"]),
            "mlp": [{"w": conv(l["w"]), "b": conv(l["b"])}
                    for l in tree["mlp"]],
            "user_proj": conv(tree["user_proj"]),
            "item_emb": conv(tree["item_emb"])}


def batch_from_numpy(batch: dict, device=None) -> dict:
    """A batch of numpy arrays (``data/recsys_data.recsys_batches``) as
    tensors on ``device`` (default ``cuda``), same keys and dtypes."""
    dev = get_device(device)
    return {k: torch.from_numpy(np.asarray(v)).to(dev)
            for k, v in batch.items()}


def train_loss(cfg: RecSysConfig, params: Params, batch):
    raise _unported("recsys training (an embedding-bag backward)")


def serve_scores(cfg: RecSysConfig, params: Params, batch):
    _check_kind(cfg)
    return wide_deep_serve_scores(cfg, params, batch)
