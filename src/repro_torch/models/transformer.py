"""Decoder-only LM, dense or MoE (port of ``repro/models/transformer.py``).

Entry points (functions of (cfg, params, inputs)):

- ``init_params(cfg, generator, device)`` -> dict (layer weights stacked
  on a leading L axis, as the JAX pytree)
- ``params_from_numpy(cfg, tree, device)`` -> the same dict from the JAX
  parameter pytree given as numpy arrays
- ``forward(cfg, params, tokens)`` -> (final-normed hidden, aux)
- ``train_loss(cfg, params, batch)`` -> scalar loss (chunked-vocab xent
  plus the MoE aux)
- ``prefill(cfg, params, tokens, max_len)`` -> (last-token logits, cache)
- ``decode_step(cfg, params, cache, token)`` -> (logits, cache)

KV cache layout: dict(k=(L, B, S, Kv, D), v=(L, B, S, Kv, D),
length=(B,)). Attention goes through ``kernels/flash_attention``
(training and prefill; under autograd its ``FlashAttention`` Function)
and ``kernels/decode_attention`` (decode): the CUDA kernels on the
card, their plain versions on the CPU. The JAX model calls the jnp twins
at ``transformer.py:125/128`` instead of its Pallas kernels. Layers run
unrolled (PyTorch is eager; there is no scan to compile), each stacked
weight unbound once a pass. An MoE layer's FFN is ``models/moe.py``: the
einsum dispatch in decode, ``moe_ffn`` (the sort dispatch for both MoE
configs) otherwise, as the reference runs without a device mesh; the
aux loss goes into ``train_loss`` and is dropped in serving, as the
reference's ``prefill`` and ``decode_step`` drop it. ``prefill`` and
``decode_step`` run under ``torch.inference_mode`` (``no_grad`` on a
mesh).

On a mesh (DTensor params and inputs, ``distributed/sharding.py``) the
same functions run the reference's sharded program: the weights are
all-gathered over the data axes before each product, the residual
stream is pinned as the reference's constraints pin it
(``distributed/act_sharding.py``), the kernels run on local shards
(whole heads regrouped for flash; decode over the sequence-sharded
cache with the kernel's log-sum-exp), the cross-entropy reduces the
vocab-sharded logits without gathering them, and an MoE layer with
``dispatch="ep"`` takes ``moe_ffn_ep``.
"""
from __future__ import annotations

import functools
from typing import Any, Dict

import numpy as np
import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import Partial, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LMConfig
from repro_torch.device import get_device
from repro_torch.distributed.act_sharding import (
    TP_AXIS, constrain_act, constrain_seq, constrain_tp_last, current_mesh,
    dp_axes_active, dp_bounds, dp_placements, embed_rows, from_local,
    gather_dp, gather_over, local_of, mesh_dim, replicated, shard_bounds,
    use_dp_axes)
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.models.attention import merge_decode_partials
from repro_torch.models.layers import (apply_rope, dense_init, embed_init,
                                       rms_norm, rope_cos_sin, swiglu)
from repro_torch.models.moe import moe_ffn, moe_ffn_einsum, moe_ffn_ep

Params = Dict[str, Any]


def _layer_shapes(cfg: LMConfig):
    d, h = cfg.d_model, cfg.head_dim
    shapes = {
        "wq": (d, cfg.n_heads * h),
        "wk": (d, cfg.n_kv_heads * h),
        "wv": (d, cfg.n_kv_heads * h),
        "wo": (cfg.n_heads * h, d),
        "ln1": (d,),
        "ln2": (d,),
    }
    if cfg.qk_norm:
        shapes["q_norm"] = (h,)
        shapes["k_norm"] = (h,)
    if cfg.is_moe:
        m = cfg.moe
        shapes.update({
            "router": (d, m.n_experts),
            "wg": (m.n_experts, d, m.d_ff_expert),
            "wu": (m.n_experts, d, m.d_ff_expert),
            "wd": (m.n_experts, m.d_ff_expert, d),
        })
        if m.n_shared_experts:
            f = m.n_shared_experts * m.d_ff_expert
            shapes.update({"shared_wg": (d, f), "shared_wu": (d, f),
                           "shared_wd": (f, d)})
    else:
        shapes.update({"wg": (d, cfg.d_ff), "wu": (d, cfg.d_ff),
                       "wd": (cfg.d_ff, d)})
    return shapes


def init_params(cfg: LMConfig, generator: torch.Generator | None = None,
                device=None) -> Params:
    """Random weights in ``cfg.dtype`` on ``device`` (default ``cuda``),
    with the distributions of the JAX ``init_params`` (truncated-normal
    fan-in dense weights, truncated-normal embeddings, unit norms). The
    draws come from ``generator`` and differ from JAX's."""
    dev = get_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    dtype = getattr(torch, cfg.dtype)
    layer = {}
    for name, shp in sorted(_layer_shapes(cfg).items()):
        stacked = (cfg.n_layers, *shp)
        if name.startswith("ln") or name.endswith("_norm"):
            layer[name] = torch.ones(stacked, dtype=dtype, device=dev)
        else:
            layer[name] = dense_init(stacked, dtype, generator, dev)
    params: Params = {
        "layers": layer,
        "embed": embed_init((cfg.vocab_size, cfg.d_model), dtype, generator,
                            dev),
        "final_ln": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = dense_init((cfg.d_model, cfg.vocab_size), dtype,
                                       generator, dev)
    return params


def params_from_numpy(cfg: LMConfig, tree, device=None) -> Params:
    """The port's parameters from the JAX parameter pytree given as
    numpy arrays (same names, same stacked layouts), in ``cfg.dtype``."""
    dev = get_device(device)
    dtype = getattr(torch, cfg.dtype)

    def conv(a):
        return torch.tensor(np.asarray(a)).to(device=dev, dtype=dtype)
    out: Params = {"layers": {n: conv(tree["layers"][n])
                              for n in _layer_shapes(cfg)}}
    for name in ("embed", "final_ln", "unembed"):
        if name in tree:
            out[name] = conv(tree[name])
    return out


def _layer_params(params: Params) -> list:
    """One dict of weights a layer, each stacked leaf unbound once: under
    autograd, indexing ``p[name][l]`` per layer would make each index's
    backward write a zero tensor the size of the whole stack (summed
    over the L layers); ``unbind`` stacks the L gradients once."""
    p = params["layers"]
    names = sorted(p)
    return [dict(zip(names, ws))
            for ws in zip(*(p[n].unbind(0) for n in names))]


def _sharded_attention(q, k, v):
    """Causal attention of DTensors on the card's kernel, run on local
    shards. q (B, S, H, D), k/v (B, S, K, D), batch sharded over the DP
    axes. The fused head axis the projections leave sharded over
    'model' need not split into whole heads (16 or 40 query, 8 or 2 kv
    heads over 16 ranks), so heads are regrouped first: q is resharded
    to whole heads over 'model' when H divides over it and each rank's
    heads fall in whole GQA groups or inside one (else q is replicated
    over 'model' and every rank computes all heads); k and v are
    replicated over 'model' (one all-gather of each a layer) and each
    rank slices the kv heads of its query heads (group ``global_head //
    G``), so their gradients are Partial over 'model'."""
    mesh = q.device_mesh
    n = mesh.size(mesh_dim(mesh, TP_AXIS))
    H, K = q.shape[2], k.shape[2]
    G = H // K
    hl = H // n
    split = H % n == 0 and (hl % G == 0 or G % hl == 0)
    q_pl = dp_placements(mesh, 0, Shard(2) if split else None)
    kv_pl = dp_placements(mesh, 0)
    kv_grad = dp_placements(mesh, 0, Partial() if split else None)
    q_l = q.redistribute(mesh, q_pl).to_local()
    k_l, v_l = (t.redistribute(mesh, kv_pl).to_local(grad_placements=kv_grad)
                for t in (k, v))
    if split:
        h0 = mesh.get_local_rank(TP_AXIS) * hl
        a, b = h0 // G, (h0 + hl - 1) // G + 1
        k_l, v_l = k_l[:, :, a:b], v_l[:, :, a:b]
    return from_local(attention(q_l, k_l, v_l), mesh, q_pl, q.shape)


def _sharded_decode(q, k_new, v_new, k_cache, v_cache, length):
    """One decode step of DTensors over a cache whose sequence axis is
    sharded over 'model' (``lm_cache_spec``), on the card's kernel. Each
    rank writes the new token's k/v IN PLACE into its own shard when it
    owns the position ``length[0]`` (a masked write: no rank reads the
    position on the host), runs the decode kernel over its positions
    with the lengths clipped to its range, and returns its partial
    output with its log-sum-exp; the partials of the 'model' ranks are
    all-gathered (D + 1 floats a head) and merged by
    ``merge_decode_partials``. No cache is gathered. q (B, 1, H, D);
    k_new, v_new (B, 1, K, D); caches (B, S, K, D)."""
    mesh = k_cache.device_mesh
    md = mesh_dim(mesh, TP_AXIS)
    pl = dp_placements(mesh, 0)
    q_l, kn, vn = (t.redistribute(mesh, pl).to_local()
                   for t in (q, k_new, v_new))
    ln = length.redistribute(mesh, pl).to_local()
    first, _ = shard_bounds(mesh, TP_AXIS, k_cache.shape[1])
    o, lse = decode_local(q_l[:, 0], kn, vn, k_cache.to_local(),
                          v_cache.to_local(), ln, first)
    n = mesh.size(md)
    outs = gather_over(o.to(torch.float32), mesh, TP_AXIS)
    lses = gather_over(lse, mesh, TP_AXIS)
    B_l = o.shape[0]
    o = merge_decode_partials(outs.reshape(n, B_l, *o.shape[1:]),
                              lses.reshape(n, B_l, -1)).to(q_l.dtype)
    return from_local(o[:, None], mesh, pl, q.shape)


def _split_heads(t, heads: int, h: int):
    """(..., heads * h) -> (..., heads, h). On a mesh whose 'model' size
    does not divide ``heads`` the fused axis cannot split into whole
    heads in place, so it is all-gathered over 'model' first."""
    if hasattr(t, "device_mesh"):
        mesh = t.device_mesh
        if heads % mesh.size(mesh_dim(mesh, TP_AXIS)):
            t = t.redistribute(mesh, dp_placements(mesh, 0))
    return t.reshape(*t.shape[:-1], heads, h)


def decode_local(q, k_new, v_new, k_cache, v_cache, length, first: int):
    """One rank's part of a decode step when its caches (B, S_loc, K, D)
    hold positions [first, first + S_loc): the new token's k/v (B, 1,
    K, D) are written IN PLACE at position ``length[0]`` if the rank
    owns it (a masked write, read on no host), and the decode kernel
    runs over the rank's positions with ``length + 1`` clipped to its
    range. q (B, H, D) -> (out (B, H, D), lse (B, H) fp32): merged over
    the ranks by ``merge_decode_partials``, the whole step."""
    cnt = k_cache.shape[1]
    if cnt:
        pos = length[:1].to(torch.int64) - first   # uniform position
        own = (pos >= 0) & (pos < cnt)
        at = pos.clamp(0, cnt - 1)
        for c, new in ((k_cache, k_new), (v_cache, v_new)):
            c.index_copy_(1, at, torch.where(own, new.to(c.dtype),
                                             c.index_select(1, at)))
    lens = (length + 1 - first).clamp(0, cnt).to(torch.int32)
    return decode_attention(q, k_cache, v_cache, lens, return_lse=True)


def _write_prefill(cache, l: int, k, v, S: int) -> None:
    """Fill positions [0, S) of layer ``l``'s cache with the prompt's
    k/v: in place on one device; on a mesh each rank copies the part of
    [0, S) its sequence shard holds."""
    if not hasattr(cache["k"], "device_mesh"):
        cache["k"][l, :, :S] = k
        cache["v"][l, :, :S] = v
        return
    mesh = cache["k"].device_mesh
    first, cnt = shard_bounds(mesh, TP_AXIS, cache["k"].shape[2])
    a, b = first, min(first + cnt, S)
    if b <= a:
        return
    pl = dp_placements(mesh, 0)
    for name, t in (("k", k), ("v", v)):
        t_l = t.redistribute(mesh, pl).to_local()
        cache[name].to_local()[l, :, :b - a] = t_l[:, a:b]


def _attention_block(cfg: LMConfig, p: Params, l: int, x, cos, sin, mode,
                     cache=None, length=None):
    """Attention sub-block of layer ``l`` with its weights ``p``. x (B,
    S, d). In decode mode the new token's k/v are written into the cache
    IN PLACE at the uniform position ``length[0]`` (the JAX model
    rewrites the whole cache with a one-hot ``where``). On a mesh (x a
    DTensor) the weights are all-gathered over the DP axes first (FSDP),
    the projections pinned as the reference pins them, and the kernels
    run on local shards (:func:`_sharded_attention`,
    :func:`_sharded_decode`)."""
    B, S, _ = x.shape
    h = cfg.head_dim
    q = _split_heads(constrain_tp_last(x @ gather_dp(p["wq"])), cfg.n_heads,
                     h)
    k = _split_heads(constrain_tp_last(x @ gather_dp(p["wk"])),
                     cfg.n_kv_heads, h)
    v = _split_heads(constrain_tp_last(x @ gather_dp(p["wv"])),
                     cfg.n_kv_heads, h)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    sharded = hasattr(q, "device_mesh")
    if mode == "decode" and sharded:
        o = _sharded_decode(q, k, v, cache["k"][l], cache["v"][l], length)
    elif mode == "decode":
        k_cache, v_cache = cache["k"][l], cache["v"][l]
        pos = length[:1].to(torch.int64)           # uniform position
        k_cache.index_copy_(1, pos, k.to(k_cache.dtype))
        v_cache.index_copy_(1, pos, v.to(v_cache.dtype))
        o = decode_attention(q[:, 0], k_cache, v_cache,
                             (length + 1).to(torch.int32))[:, None]
    else:
        o = _sharded_attention(q, k, v) if sharded else attention(q, k, v)
        if cache is not None:                      # prefill fills [0, S)
            _write_prefill(cache, l, k, v, S)
    o = constrain_tp_last(o.reshape(B, S, cfg.n_heads * h))
    return o @ gather_dp(p["wo"])


_MOE_WEIGHTS = ("router", "wg", "wu", "wd", "shared_wg", "shared_wu",
                "shared_wd")


def _ffn_block(cfg: LMConfig, p: Params, x, mode: str):
    """FFN sub-block. x (B, S, d) -> (y, aux). MoE: the einsum dispatch
    in decode (few tokens); with ``dispatch == "ep"`` under a mesh
    (``act_sharding.current_mesh``) whose size divides the token count,
    ``moe_ffn_ep``; ``moe_ffn`` otherwise, as the reference routes; aux
    its load-balance loss. Dense: aux None."""
    if not cfg.is_moe:
        return swiglu(x, gather_dp(p["wg"]), gather_dp(p["wu"]),
                      gather_dp(p["wd"])), None
    B, S, d = x.shape
    w = {n: p[n] for n in _MOE_WEIGHTS if n in p}
    flat = x.reshape(B * S, d)
    mesh = current_mesh()
    if mode == "decode":
        y, aux = moe_ffn_einsum(flat, w, cfg.moe)
    elif cfg.moe.dispatch == "ep" and mesh is not None \
            and flat.shape[0] % mesh.size() == 0:
        y, aux = moe_ffn_ep(flat, w, cfg.moe, mesh)
    else:
        y, aux = moe_ffn(flat, w, cfg.moe)
    if hasattr(y, "device_mesh") and B % y.device_mesh.size():
        # tokens sharded over every axis (EP) do not split into (B, S)
        # when B does not: back to batch rows over the DP axes
        y = constrain_act(y)
    return y.reshape(B, S, d), aux


def _layer(cfg: LMConfig, mode: str, l: int, p: Params, x, cos, sin,
           cache=None, length=None):
    """One layer; on a mesh the residual stream is pinned as the
    reference pins it (batch over the DP axes; with ``seq_parallel``
    outside decode and S % 16 == 0 the layer exits with its sequence
    sharded over 'model')."""
    sp = cfg.seq_parallel and mode != "decode" and x.shape[1] % 16 == 0
    x = constrain_act(x)            # gather the seq-sharded carry
    x = constrain_act(x + _attention_block(
        cfg, p, l, rms_norm(x, p["ln1"], cfg.norm_eps), cos, sin, mode,
        cache, length))
    f, aux = _ffn_block(cfg, p, rms_norm(x, p["ln2"], cfg.norm_eps), mode)
    out = x + f
    return (constrain_seq(out) if sp else constrain_act(out)), aux


def _in_this_context(fn):
    """``fn`` run under the DP axes and mesh active now
    (``act_sharding.use_dp_axes``): a remat recompute runs inside the
    backward, which for CUDA tensors autograd runs on a thread of its
    own, where this thread's context variables are not set."""
    axes, mesh = dp_axes_active(), current_mesh()

    def run(*args):
        with use_dp_axes(axes, mesh=mesh):
            return fn(*args)
    return run


def _layers(cfg: LMConfig, params: Params, x, cos, sin, mode, cache=None,
            length=None):
    """Run every layer; returns (x, aux summed over the layers, fp32).
    In train mode under autograd with ``cfg.remat``, each layer runs
    inside ``torch.utils.checkpoint`` (non-reentrant): only its input is
    kept, and the backward recomputes the layer (the reference's
    ``jax.checkpoint`` with ``nothing_saveable``)."""
    aux = replicated(torch.zeros((), dtype=torch.float32,
                                 device=local_of(x).device), x)
    remat = mode == "train" and cfg.remat and torch.is_grad_enabled()
    layer = _in_this_context(_layer) if remat else _layer
    for l, p in enumerate(_layer_params(params)):
        if remat:
            x, a = checkpoint(layer, cfg, mode, l, p, x, cos, sin,
                              use_reentrant=False)
        else:
            x, a = _layer(cfg, mode, l, p, x, cos, sin, cache, length)
        if a is not None:
            aux = aux + a
    return x, aux


def forward(cfg: LMConfig, params: Params, tokens: torch.Tensor):
    """Training/scoring forward. tokens (B, S) int -> (final-normed
    hidden (B, S, d), aux: the MoE load-balance losses summed over the
    layers, 0 for a dense model)."""
    S = tokens.shape[1]
    x = _seq_in(cfg, embed_rows(params["embed"], tokens))
    cos, sin = _rope(cfg, S, x)
    x, aux = _layers(cfg, params, x, cos, sin, "train")
    return rms_norm(x, params["final_ln"], cfg.norm_eps), aux


def _seq_in(cfg: LMConfig, x):
    """The embedded stream pinned as the reference pins it: sequence
    over 'model' with ``seq_parallel`` and S % 16 == 0, else batch-only
    (no-ops on one device)."""
    return constrain_seq(x) if cfg.seq_parallel and x.shape[1] % 16 == 0 \
        else constrain_act(x)


def _rope(cfg: LMConfig, S: int, like):
    """The rotary tables of positions [0, S), replicated DTensors on a
    mesh."""
    pos = replicated(torch.arange(S, device=local_of(like).device), like)
    return rope_cos_sin(pos, cfg.head_dim, cfg.rope_theta)


def _unembed_weight(cfg: LMConfig, params: Params):
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return gather_dp(w)


def train_loss(cfg: LMConfig, params: Params, batch: Dict[str, Any],
               vocab_chunk_seq: int = 512, aux_weight: float = 0.01):
    """Next-token xent with sequence-chunked unembedding: the (B, S, V)
    logits are made a chunk of ``vocab_chunk_seq`` positions at a time
    (S must split into ``max(1, S // vocab_chunk_seq)`` equal chunks, as
    in the reference); labels < 0 are masked. Returns
    ``total / n_tok + aux_weight * aux / n_layers``. Under autograd each
    chunk's fp32 logits stay saved for the backward, as the reference's
    scan keeps them."""
    tokens, labels = batch["tokens"], batch["labels"]
    B, S = tokens.shape
    hidden, aux = forward(cfg, params, tokens)
    hidden = constrain_act(hidden)
    w = _unembed_weight(cfg, params)
    n_chunks = max(1, S // vocab_chunk_seq)
    hs = hidden.reshape(B, n_chunks, S // n_chunks, cfg.d_model)
    ls = labels.reshape(B, n_chunks, S // n_chunks)
    total = 0.0
    for c in range(n_chunks):
        y = ls[:, c]
        logits = constrain_tp_last((hs[:, c] @ w).to(torch.float32))
        if hasattr(logits, "device_mesh"):
            logz, gold = _sharded_xent(logits, y)
        else:
            logz = torch.logsumexp(logits, dim=-1)
            # the gold logit of a masked label (< 0) is read at id 0 and
            # masked out below, as the reference's masked reduce drops it
            gold = torch.take_along_dim(
                logits, y.clamp_min(0).long()[..., None], dim=-1)[..., 0]
        mask = (y >= 0).to(torch.float32)
        total = total + torch.sum((logz - gold) * mask)
    n_tok = torch.clamp(torch.sum((labels >= 0).to(torch.float32)), min=1.0)
    return total / n_tok + aux_weight * aux / cfg.n_layers


def _sharded_xent(logits, y):
    """(logsumexp, gold logit) over a vocab axis sharded over 'model',
    the reference's masked reduce: each rank reduces its vocab slice (a
    max, a sum of exponentials, the gold logit where the label falls in
    its slice) and the partial results are summed over 'model'; no
    logits are gathered. logits (B, c, V) fp32 DTensor, y (B, c)."""
    mesh = logits.device_mesh
    md = mesh_dim(mesh, TP_AXIS)
    rows = dp_placements(mesh, 0)
    lg = logits.redistribute(mesh, dp_placements(mesh, 0, Shard(2))) \
        .to_local()
    y_l = y.redistribute(mesh, rows).to_local()
    first, _ = shard_bounds(mesh, TP_AXIS, logits.shape[-1])
    # the max is a shift only (no gradient through it)
    m = funcol.all_reduce(lg.detach().amax(-1), "max", (mesh, md))
    part = dp_placements(mesh, 0, Partial())
    shape = tuple(logits.shape[:-1])
    sumexp = from_local(torch.exp(lg - m[..., None]).sum(-1), mesh, part,
                        shape).redistribute(mesh, rows)
    vpos = torch.arange(lg.shape[-1], device=lg.device) + first
    gold = from_local(torch.where(vpos == y_l[..., None].long(), lg, 0.0)
                      .sum(-1), mesh, part, shape)
    logz = torch.log(sumexp) + from_local(m, mesh, rows, shape)
    return logz, gold.redistribute(mesh, rows)


def _serving(fn):
    """Run ``fn(cfg, params, ...)`` under ``torch.inference_mode``, or
    under ``no_grad`` when the params are DTensors (a DTensor's views of
    tensors made outside inference mode cannot be taken inside it)."""
    @functools.wraps(fn)
    def run(cfg, params, *args, **kwargs):
        sharded = hasattr(params["embed"], "device_mesh")
        with (torch.no_grad() if sharded else torch.inference_mode()):
            return fn(cfg, params, *args, **kwargs)
    return run


@_serving
def prefill(cfg: LMConfig, params: Params, tokens: torch.Tensor,
            max_len: int | None = None):
    """Serving prefill: tokens (B, S) -> (last-position logits (B, V)
    fp32, KV cache with S positions filled of max(max_len, S)). Attends
    over the padded prompt, as the JAX prefill does."""
    B, S = tokens.shape
    dtype = params["embed"].dtype
    x = _seq_in(cfg, embed_rows(params["embed"], tokens))
    cos, sin = _rope(cfg, S, x)
    S_max = max(S, max_len or 0)
    shape = (cfg.n_layers, B, S_max, cfg.n_kv_heads, cfg.head_dim)
    cache = {"k": _cache_zeros(shape, dtype, x),
             "v": _cache_zeros(shape, dtype, x)}
    x, _ = _layers(cfg, params, x, cos, sin, "prefill", cache=cache)
    x = rms_norm(constrain_act(x), params["final_ln"], cfg.norm_eps)
    logits = constrain_tp_last(x[:, -1] @ _unembed_weight(cfg, params))
    length = torch.full((B,), S, dtype=torch.int32, device=local_of(x).device)
    if hasattr(x, "device_mesh"):
        length = from_local(length[:local_of(x).shape[0]], x.device_mesh,
                            dp_placements(x.device_mesh, 0), (B,))
    cache["length"] = length
    return logits.to(torch.float32), cache


def _cache_zeros(shape, dtype, like):
    """A zero (L, B, S, K, D) cache on ``like``'s device, or on a mesh a
    DTensor placed by ``lm_cache_spec`` (batch over the DP axes,
    sequence over 'model'), each rank allocating its shard only."""
    if not hasattr(like, "device_mesh"):
        return torch.zeros(shape, dtype=dtype, device=like.device)
    mesh = like.device_mesh
    L, B, S, K, D = shape
    local = (L, dp_bounds(mesh, B)[1], shard_bounds(mesh, TP_AXIS, S)[1],
             K, D)
    return from_local(torch.zeros(local, dtype=dtype,
                                  device=local_of(like).device), mesh,
                      [Shard(2) if n == TP_AXIS else Shard(1)
                       for n in mesh.mesh_dim_names], shape)


@_serving
def decode_step(cfg: LMConfig, params: Params, cache: Dict[str, Any],
                token: torch.Tensor):
    """One decode step. token (B,) -> (logits (B, V) fp32, cache). The
    cache's k/v are updated in place; the returned cache shares them
    and carries ``length + 1``."""
    x = constrain_act(embed_rows(params["embed"], token))[:, None, :]
    pos = cache["length"]                                 # (B,)
    cos, sin = rope_cos_sin(pos[:, None], cfg.head_dim, cfg.rope_theta)
    x, _ = _layers(cfg, params, x, cos, sin, "decode", cache=cache,
                   length=pos)
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    logits = constrain_tp_last(x[:, 0] @ _unembed_weight(cfg, params))
    new_cache = {"k": cache["k"], "v": cache["v"], "length": pos + 1}
    return logits.to(torch.float32), new_cache
