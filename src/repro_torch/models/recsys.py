"""RecSys models (port of ``repro/models/recsys.py``): SASRec, MIND, BST
and Wide&Deep, plus EmbeddingBag.

Plain functions over a params dict (nested dicts and lists of tensors,
the JAX package's tree), as in the JAX module:

    init_params(cfg, generator, device)      # random weights
    params_from_numpy(cfg, tree, device)     # the JAX parameter tree
    train_loss(cfg, params, batch)           # 'train_batch'
    serve_scores(cfg, params, batch)         # 'serve_p99' / 'serve_bulk'
    user_repr(cfg, params, batch)            # query-side tower
    retrieval(cfg, params, batch, k)         # 'retrieval_cand'
    retrieval_sharded(cfg, params, batch, mesh, k)   # the same, sharded

Wide&Deep's fixed-shape bag reduce goes through ``kernels/embedding_bag``:
the hand-written CUDA kernel on the card (under autograd, with the
backward kernel that writes each gradient row once, when the table
needs a gradient), its plain version on the CPU. The JAX model computes it with ``jnp.take`` and a
masked sum (``recsys.py:59``) and never reaches its Pallas kernel. The
port's mean mode weighs each id by ``mask / max(count, 1)`` and sums,
where the JAX package sums ``mask * row`` and divides, so the two differ
by ulps.

SASRec's and BST's attention is the reference's jnp attention, written
here as fp32 einsum composites (:func:`_sasrec_attention`,
:func:`_bst_attention`): their head dims (50, and 32 / 8 = 4) lie
outside the CUDA attention kernels' and BST's is not causal, and the
reference's recsys path reaches no Pallas kernel either. MIND's capsule
routing runs in fp32 with no attention. Item lookups are plain
gathers, as the reference's ``jnp.take``.

On a mesh (DTensor params and batch, ``distributed/sharding.py``) the
tables of >= 4096 rows are row-sharded over 'model': a lookup
(``act_sharding.embed_rows``) and a bag (:func:`embedding_bag`) run on
each rank's rows, ids outside its range weighted 0, and the result is
summed over 'model'; the bag kernel runs on the local shard. Retrieval
candidates are sharded over 'model' (``recsys_batch_spec``).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from torch.distributed.tensor import Partial, Shard

from repro_torch.configs.base import RecSysConfig
# batch_from_numpy lives in device.py; kept importable from here
from repro_torch.device import batch_from_numpy, get_device  # noqa: F401
from repro_torch.distributed.act_sharding import (
    TP_AXIS, embed_rows, from_local, gather_dp, gather_over, local_of,
    local_weight, mesh_dim, replicated, shard_bounds)
from repro_torch.index.flat import topk_lowest_index, topk_scores
from repro_torch.kernels.embedding_bag.ops import embedding_bag as _bag
from repro_torch.models.layers import dense_init, embed_init, rms_norm
from repro_torch.tree import tree_map

Params = Dict[str, Any]


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
    if hasattr(table, "device_mesh"):
        return _sharded_bag(table, ids, w, groups)
    out = _bag(table, ids.reshape(-1, m), w.reshape(-1, m), groups)
    return out.reshape(*ids.shape[:-1], table.shape[1]).to(table.dtype)


def _sharded_bag(table, ids, w, groups: int):
    """The bag of a DTensor table on each rank's local shard
    (:func:`local_bag`): with the rows sharded over 'model' the result
    is Partial over 'model'; with replicated rows the bag is local.
    ids/w keep their (data-parallel) placements."""
    mesh = table.device_mesh
    t = gather_dp(table)
    ids, w = replicated(ids, table), replicated(w, table)
    md = mesh_dim(mesh, TP_AXIS)
    m = ids.shape[-1]
    ids_l = ids.to_local()
    w_l = w.to_local()
    pl = list(ids.placements)
    first = 0
    if isinstance(t.placements[md], Shard) and t.placements[md].dim == 0:
        first = shard_bounds(mesh, TP_AXIS, table.shape[0])[0]
        pl[md] = Partial()
    out = local_bag(local_weight(t), first, ids_l, w_l, groups)
    return from_local(out, mesh, pl, (*ids.shape[:-1], table.shape[1]))


def local_bag(shard: torch.Tensor, first: int, ids: torch.Tensor,
              w: torch.Tensor, groups: int) -> torch.Tensor:
    """One rank's part of the weighted bag when it holds rows [first,
    first + len(shard)) of the table: ids outside the range get weight 0
    (and an in-range id, clamped), and the bag kernel sums the rest on
    the shard. ids/w (..., m) -> (..., d) in the shard's dtype; summed
    over the ranks, the whole bag."""
    m, cnt = ids.shape[-1], shard.shape[0]
    loc = ids - first
    ok = (loc >= 0) & (loc < cnt)
    loc = loc.clamp(0, max(cnt - 1, 0)).to(ids.dtype)
    out = _bag(shard, loc.reshape(-1, m),
               torch.where(ok, w, 0.0).reshape(-1, m), groups)
    return out.reshape(*ids.shape[:-1], shard.shape[1]).to(shard.dtype)


def bag_weights(ids: torch.Tensor, mask: torch.Tensor | None,
                mode: str) -> torch.Tensor:
    """The (..., m) fp32 weights of :func:`embedding_bag`'s weighted sum
    for ``mode`` 'mean' or 'sum'."""
    if mode not in ("mean", "sum"):
        raise ValueError(mode)
    if mask is None:
        m = ids.shape[-1]
        return torch.full_like(ids, 1.0 / m if mode == "mean" else 1.0,
                               dtype=torch.float32)
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


NEG_INF = -1e30     # the reference's attention mask value


def _attn_block_init(generator, d, dtype, device):
    def w(a, b):
        return dense_init((a, b), dtype, generator, device)
    return {"wq": w(d, d), "wk": w(d, d), "wv": w(d, d), "wo": w(d, d),
            "ln1": torch.ones((d,), dtype=dtype, device=device),
            "ln2": torch.ones((d,), dtype=dtype, device=device),
            "w1": w(d, 4 * d), "w2": w(4 * d, d)}


def _sasrec_attention(q, k, v):
    """Counterpart of the reference's jnp ``causal_attention``
    (``repro/models/attention.py:39``) as SASRec calls it, with chunk =
    S, one block: fp32 scores scaled by D**-0.5, positions after the
    query masked to NEG_INF, the block's online softmax (the row max,
    exp, the sum of p times v over the sum of p), cast to q's dtype.
    q, k, v (B, S, H, D) -> (B, S, H, D)."""
    S, D = q.shape[1], q.shape[3]
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) * D ** -0.5
    causal = replicated(torch.tril(torch.ones(
        (S, S), dtype=torch.bool, device=local_of(q).device)), s)
    s = torch.where(causal, s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v).to(torch.float32)
    return (o / p.sum(-1).transpose(1, 2)[..., None]).to(q.dtype)


def _bst_attention(q, k, v):
    """Counterpart of the reference's inline non-causal einsum softmax
    in ``_attn_block`` (``repro/models/recsys.py:116-118``): scores,
    then the softmax in fp32, then the cast. q, k, v (B, S, H, D) ->
    (B, S, H, D)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[3] ** -0.5
    p = torch.softmax(s.to(torch.float32), -1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _attn_block(p, x, n_heads, causal=True):
    """Pre-LN transformer block over (B, S, d)."""
    B, S, d = x.shape
    h = d // n_heads
    xn = rms_norm(x, p["ln1"])
    q = (xn @ p["wq"]).reshape(B, S, n_heads, h)
    k = (xn @ p["wk"]).reshape(B, S, n_heads, h)
    v = (xn @ p["wv"]).reshape(B, S, n_heads, h)
    o = _sasrec_attention(q, k, v) if causal else _bst_attention(q, k, v)
    x = x + o.reshape(B, S, d) @ p["wo"]
    xn = rms_norm(x, p["ln2"])
    return x + torch.relu(xn @ p["w1"]) @ p["w2"]


def _softplus_bce(z, y):
    """max(z, 0) - z y + log1p(exp(-|z|)), elementwise in fp32
    (``torch.maximum`` splits the gradient of a tie as ``jnp.maximum``)."""
    return torch.maximum(z, torch.zeros_like(z)) - z * y \
        + torch.log1p(torch.exp(-torch.abs(z)))


def _bce(logits, labels):
    return torch.mean(_softplus_bce(logits.to(torch.float32),
                                    labels.to(torch.float32)))


# ---------------------------------------------------------------------------
# SASRec  [arXiv:1808.09781]
# ---------------------------------------------------------------------------

def sasrec_init(cfg: RecSysConfig, generator: torch.Generator,
                device) -> Params:
    dtype, d = getattr(torch, cfg.dtype), cfg.embed_dim
    return {
        "item_emb": embed_init((_table_rows(cfg.n_items + 1), d), dtype,
                               generator, device) * d ** -0.5,
        "pos_emb": embed_init((cfg.seq_len, d), dtype, generator, device)
        * d ** -0.5,
        "blocks": [_attn_block_init(generator, d, dtype, device)
                   for _ in range(cfg.n_blocks)],
        "final_ln": torch.ones((d,), dtype=dtype, device=device),
    }


def sasrec_encode(cfg: RecSysConfig, params: Params, seq):
    """seq (B, S) item ids (0 = pad) -> (B, S, d)."""
    x = embed_rows(params["item_emb"], seq) + params["pos_emb"]
    x = x * (seq > 0)[..., None].to(x.dtype)
    for p in params["blocks"]:
        x = _attn_block(p, x, cfg.n_heads, causal=True)
    return rms_norm(x, params["final_ln"])


def sasrec_train_loss(cfg: RecSysConfig, params: Params, batch):
    """BCE over (positive, sampled-negative) next items per position."""
    h = sasrec_encode(cfg, params, batch["seq"])        # (B, S, d)
    pos_e = embed_rows(params["item_emb"], batch["pos"])
    neg_e = embed_rows(params["item_emb"], batch["neg"])
    pos_s = torch.einsum("bsd,bsd->bs", h, pos_e)
    neg_s = torch.einsum("bsd,bsd->bs", h, neg_e)
    mask = (batch["pos"] > 0).to(torch.float32)
    z = torch.stack([pos_s, neg_s], -1).to(torch.float32)
    y = torch.stack([torch.ones_like(pos_s), torch.zeros_like(neg_s)], -1)
    per = _softplus_bce(z, y)
    return torch.sum(per.sum(-1) * mask) \
        / torch.clamp(mask.sum(), min=1.0)


def sasrec_user_repr(cfg, params, batch):
    return sasrec_encode(cfg, params, batch["seq"])[:, -1]   # (B, d)


def sasrec_serve_scores(cfg, params, batch):
    """Score candidate items per request: cands (B, n_c)."""
    u = sasrec_user_repr(cfg, params, batch)
    c = embed_rows(params["item_emb"], batch["cands"])
    return torch.einsum("bd,bcd->bc", u, c)


# ---------------------------------------------------------------------------
# MIND  [arXiv:1904.08030]
# ---------------------------------------------------------------------------

def mind_init(cfg: RecSysConfig, generator: torch.Generator,
              device) -> Params:
    dtype, d = getattr(torch, cfg.dtype), cfg.embed_dim
    return {
        "item_emb": embed_init((_table_rows(cfg.n_items + 1), d), dtype,
                               generator, device) * d ** -0.5,
        "bilinear": dense_init((d, d), dtype, generator, device),
        # fixed (untrained) routing-logit init, one per (interest, position)
        "routing_init": embed_init((cfg.n_interests, cfg.seq_len), dtype,
                                   generator, device) * 0.1,
        "mlp": _mlp_init(generator, (d, 4 * d, d), dtype, device),
    }


def _squash(z):
    n2 = torch.sum(z * z, -1, keepdim=True)
    return (n2 / (1 + n2)) * z / torch.sqrt(n2 + 1e-9)


def mind_interests(cfg: RecSysConfig, params: Params, seq):
    """Multi-interest extraction by B2I dynamic routing, in fp32 ->
    (B, K, d)."""
    e = embed_rows(params["item_emb"], seq)                   # (B, S, d)
    valid = (seq > 0).to(torch.float32)                  # (B, S)
    eh = (e @ params["bilinear"]).to(torch.float32)      # shared S matrix
    b = params["routing_init"].to(torch.float32)[None].expand(
        seq.shape[0], cfg.n_interests, cfg.seq_len)
    u = None
    for _ in range(cfg.capsule_iters):
        w = torch.softmax(b, dim=1)                      # over interests
        w = w * valid[:, None, :]
        u = _squash(torch.einsum("bks,bsd->bkd", w, eh))
        b = b + torch.einsum("bkd,bsd->bks", u, eh)
    return _mlp(params["mlp"], u.to(e.dtype), final_act=False)


def mind_train_loss(cfg: RecSysConfig, params: Params, batch):
    """Label-aware attention + sampled softmax vs provided negatives."""
    u = mind_interests(cfg, params, batch["seq"])        # (B, K, d)
    tgt = embed_rows(params["item_emb"], batch["pos"])        # (B, d)
    att = torch.softmax(
        torch.einsum("bkd,bd->bk", u, tgt).to(torch.float32) * 2.0, -1)
    v_u = torch.einsum("bk,bkd->bd", att.to(u.dtype), u)     # (B, d)
    neg = embed_rows(params["item_emb"], batch["neg"])        # (B, N, d)
    pos_s = torch.einsum("bd,bd->b", v_u, tgt)[:, None]
    neg_s = torch.einsum("bd,bnd->bn", v_u, neg)
    logits = torch.cat([pos_s, neg_s], -1).to(torch.float32)
    return -torch.mean(torch.log_softmax(logits, -1)[:, 0])


def mind_user_repr(cfg, params, batch):
    return mind_interests(cfg, params, batch["seq"])     # (B, K, d)


def mind_serve_scores(cfg, params, batch):
    u = mind_user_repr(cfg, params, batch)               # (B, K, d)
    c = embed_rows(params["item_emb"], batch["cands"])        # (B, n_c, d)
    return torch.einsum("bkd,bcd->bkc", u, c).amax(dim=1)   # max over K


# ---------------------------------------------------------------------------
# BST  [arXiv:1905.06874]
# ---------------------------------------------------------------------------

def bst_init(cfg: RecSysConfig, generator: torch.Generator,
             device) -> Params:
    dtype, d = getattr(torch, cfg.dtype), cfg.embed_dim
    # sequence includes the target item appended at the end (paper fig. 1)
    flat = (cfg.seq_len + 1) * d
    return {
        "item_emb": embed_init((_table_rows(cfg.n_items + 1), d), dtype,
                               generator, device) * d ** -0.5,
        "pos_emb": embed_init((cfg.seq_len + 1, d), dtype, generator,
                              device) * d ** -0.5,
        "blocks": [_attn_block_init(generator, d, dtype, device)
                   for _ in range(cfg.n_blocks)],
        "mlp": _mlp_init(generator, (flat, *cfg.mlp_dims, 1), dtype, device),
        "user_proj": dense_init((flat, d), dtype, generator, device),
    }


def _bst_encode(cfg, params, seq, target):
    x_ids = torch.cat([seq, target[:, None].to(seq.dtype)], dim=1)
    x = embed_rows(params["item_emb"], x_ids) + params["pos_emb"]
    for p in params["blocks"]:
        x = _attn_block(p, x, cfg.n_heads, causal=False)
    return x.reshape(x.shape[0], -1)                     # (B, (S+1)*d)


def bst_train_loss(cfg: RecSysConfig, params: Params, batch):
    flat = _bst_encode(cfg, params, batch["seq"], batch["target"])
    return _bce(_mlp(params["mlp"], flat)[:, 0], batch["label"])


def bst_serve_scores(cfg, params, batch):
    """CTR per (request, candidate): cands (B, n_c). The reference maps
    the encoder over the candidate axis; here the B * n_c (request,
    candidate) rows go through it as one batch, row b * n_c + c."""
    B, n_c = batch["cands"].shape
    seq = batch["seq"].repeat_interleave(n_c, dim=0)
    flat = _bst_encode(cfg, params, seq, batch["cands"].reshape(-1))
    return _mlp(params["mlp"], flat)[:, 0].reshape(B, n_c)


def bst_user_repr(cfg, params, batch):
    """Target-free user tower (retrieval approximation, see DESIGN.md)."""
    pad = torch.zeros_like(batch["seq"][:, 0])
    flat = _bst_encode(cfg, params, batch["seq"], pad)
    return flat @ params["user_proj"]


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
    offs = replicated(torch.arange(cfg.n_sparse, dtype=ids.dtype,
                                   device=local_of(ids).device) * cfg.sparse_vocab, ids)
    return ids + offs[None, :, None]


def wide_deep_logit(cfg: RecSysConfig, params: Params, batch):
    gids = _wd_field_ids(cfg, batch["sparse_ids"])       # (B, F, m)
    mask = batch.get("sparse_mask")
    bags = embedding_bag(params["tables"], gids, mask)   # (B, F, d)
    deep = _mlp(params["mlp"], bags.reshape(bags.shape[0], -1))[:, 0]
    wide = embedding_bag(params["wide"], gids, mask, mode="sum")
    return deep + wide.sum(dim=(1, 2))


def wide_deep_train_loss(cfg, params, batch):
    return _bce(wide_deep_logit(cfg, params, batch), batch["label"])


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
    """Score the user repr against a large candidate set by raw dot, ties
    to the lowest candidate position; returns (scores (B, k), ids (B,
    k)). A (B, d) user vector goes through ``index/flat.topk_scores``; a
    multi-interest (B, I, d) one (MIND) scores each candidate by its
    best interest, then takes the same top-k (``topk_lowest_index``:
    ``torch.topk`` does not order ties)."""
    u = user_repr(cfg, params, batch)
    cand = embed_rows(params["item_emb"], batch["cand_ids"])
    if hasattr(cand, "device_mesh"):
        return _sharded_retrieval(u, cand, batch["cand_ids"], k)
    if u.dim() == 3:
        scores = torch.einsum("bkd,cd->bkc", u, cand).amax(dim=1)
        vals, idx = topk_lowest_index(scores.to(torch.float32), k)
        return vals, batch["cand_ids"][idx.long()]
    return topk_scores(u, cand, batch["cand_ids"], k)


def _sharded_retrieval(u, cand, cand_ids, k: int):
    """:func:`retrieval`'s top-k over candidates sharded over 'model':
    each rank scores its contiguous block of candidates and keeps its
    top k (ties to the lowest position); the (score, id) lists of the
    'model' ranks are all-gathered and merged in rank order by the same
    rule, which keeps the lowest global position among ties. Returns
    replicated DTensors (scores (B, k), ids (B, k))."""
    from torch.distributed.tensor import Replicate
    mesh = cand.device_mesh
    md = mesh_dim(mesh, TP_AXIS)
    rep = [Replicate()] * mesh.ndim
    rows = [Shard(0) if i == md else Replicate() for i in range(mesh.ndim)]
    u_l = u.redistribute(mesh, rep).to_local() \
        if hasattr(u, "device_mesh") else u
    c_l = cand.redistribute(mesh, rows).to_local()
    ids_l = cand_ids.redistribute(mesh, rows).to_local()
    if u_l.dim() == 3:
        scores = torch.einsum("bkd,cd->bkc", u_l, c_l).amax(dim=1)
    else:
        scores = u_l @ c_l.T
    pad = max(k - c_l.shape[0], 0)       # a short shard: -inf, id -1
    scores = torch.nn.functional.pad(scores.to(torch.float32), (0, pad),
                                     value=float("-inf"))
    ids_l = torch.nn.functional.pad(ids_l, (0, pad), value=-1)
    vals, idx = topk_lowest_index(scores, k)
    n = mesh.size(md)
    B = vals.shape[0]
    all_v = gather_over(vals, mesh, TP_AXIS).reshape(n, B, k)
    all_i = gather_over(ids_l[idx.long()], mesh, TP_AXIS).reshape(n, B, k)
    v, j = topk_lowest_index(all_v.transpose(0, 1).reshape(B, n * k), k)
    ids = all_i.transpose(0, 1).reshape(B, n * k).gather(1, j.long())
    return (from_local(v, mesh, rep, tuple(v.shape)),
            from_local(ids, mesh, rep, tuple(ids.shape)))


def user_repr(cfg: RecSysConfig, params: Params, batch):
    """(B, d) user vectors; (B, n_interests, d) for MIND."""
    return USER_REPR[cfg.kind](cfg, params, batch)


def retrieval_sharded(cfg: RecSysConfig, params: Params, batch, mesh,
                      k: int = 100):
    """Retrieval with the item table row-sharded over ``mesh`` and
    range-partitioned candidates (``batch["cand_ids"]`` split into equal
    blocks, block ``s`` holding ids of shard ``s``'s rows): the gather
    and the top-k run a shard, and only k candidates a shard reach the
    merge (``index/sharded.sharded_topk_local_candidates``, which takes
    MIND's (B, I, d) vectors too). Returns (scores (B, k), ids (B, k)),
    those of :func:`retrieval` on such a candidate list."""
    from repro_torch.index.sharded import sharded_topk_local_candidates
    u = user_repr(cfg, params, batch)
    return sharded_topk_local_candidates(
        u, params["item_emb"], batch["cand_ids"], mesh, k=k)


INIT = {"sasrec": sasrec_init, "mind": mind_init, "bst": bst_init,
        "wide_deep": wide_deep_init}
TRAIN_LOSS = {"sasrec": sasrec_train_loss, "mind": mind_train_loss,
              "bst": bst_train_loss, "wide_deep": wide_deep_train_loss}
SERVE = {"sasrec": sasrec_serve_scores, "mind": mind_serve_scores,
         "bst": bst_serve_scores, "wide_deep": wide_deep_serve_scores}
USER_REPR = {"sasrec": sasrec_user_repr, "mind": mind_user_repr,
             "bst": bst_user_repr, "wide_deep": wide_deep_user_repr}
PORTED_KINDS = tuple(INIT)


def init_params(cfg: RecSysConfig, generator: torch.Generator | None = None,
                device=None) -> Params:
    """Random weights in ``cfg.dtype`` on ``device`` (default ``cuda``),
    with the distributions of the JAX ``init_params``; ``generator``
    (on that device) defaults to seed 0."""
    dev = get_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return INIT[cfg.kind](cfg, generator, dev)


def params_from_numpy(cfg: RecSysConfig, tree, device=None) -> Params:
    """The port's parameters from the JAX parameter tree given as numpy
    arrays (the same nested dicts and lists: ``mlp`` and ``blocks`` are
    lists), in ``cfg.dtype``."""
    dev = get_device(device)
    dtype = getattr(torch, cfg.dtype)
    return tree_map(lambda a: torch.tensor(np.asarray(a)).to(
        device=dev, dtype=dtype), tree)


def train_loss(cfg: RecSysConfig, params: Params, batch):
    return TRAIN_LOSS[cfg.kind](cfg, params, batch)


def serve_scores(cfg: RecSysConfig, params: Params, batch):
    return SERVE[cfg.kind](cfg, params, batch)
