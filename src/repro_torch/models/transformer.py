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
``decode_step`` run under ``torch.inference_mode``.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LMConfig
from repro_torch.device import get_device
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.models.layers import (apply_rope, dense_init, embed_init,
                                       rms_norm, rope_cos_sin, swiglu)
from repro_torch.models.moe import moe_ffn, moe_ffn_einsum

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


def _attention_block(cfg: LMConfig, p: Params, l: int, x, cos, sin, mode,
                     cache=None, length=None):
    """Attention sub-block of layer ``l`` with its weights ``p``. x (B,
    S, d). In decode mode the new token's k/v are written into the cache
    IN PLACE at the uniform position ``length[0]`` (the JAX model
    rewrites the whole cache with a one-hot ``where``)."""
    B, S, _ = x.shape
    h = cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, cfg.n_heads, h)
    k = (x @ p["wk"]).reshape(B, S, cfg.n_kv_heads, h)
    v = (x @ p["wv"]).reshape(B, S, cfg.n_kv_heads, h)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if mode == "decode":
        k_cache, v_cache = cache["k"][l], cache["v"][l]
        pos = length[:1].to(torch.int64)           # uniform position
        k_cache.index_copy_(1, pos, k.to(k_cache.dtype))
        v_cache.index_copy_(1, pos, v.to(v_cache.dtype))
        o = decode_attention(q[:, 0], k_cache, v_cache,
                             (length + 1).to(torch.int32))[:, None]
    else:
        o = attention(q, k, v)
        if cache is not None:                      # prefill fills [0, S)
            cache["k"][l, :, :S] = k
            cache["v"][l, :, :S] = v
    return o.reshape(B, S, cfg.n_heads * h) @ p["wo"]


_MOE_WEIGHTS = ("router", "wg", "wu", "wd", "shared_wg", "shared_wu",
                "shared_wd")


def _ffn_block(cfg: LMConfig, p: Params, x, mode: str):
    """FFN sub-block. x (B, S, d) -> (y, aux). MoE: the einsum dispatch
    in decode (few tokens), ``moe_ffn`` otherwise, aux its load-balance
    loss; dense: aux None."""
    if not cfg.is_moe:
        return swiglu(x, p["wg"], p["wu"], p["wd"]), None
    B, S, d = x.shape
    w = {n: p[n] for n in _MOE_WEIGHTS if n in p}
    ffn = moe_ffn_einsum if mode == "decode" else moe_ffn
    y, aux = ffn(x.reshape(B * S, d), w, cfg.moe)
    return y.reshape(B, S, d), aux


def _layer(cfg: LMConfig, mode: str, l: int, p: Params, x, cos, sin,
           cache=None, length=None):
    x = x + _attention_block(cfg, p, l, rms_norm(x, p["ln1"], cfg.norm_eps),
                             cos, sin, mode, cache, length)
    f, aux = _ffn_block(cfg, p, rms_norm(x, p["ln2"], cfg.norm_eps), mode)
    return x + f, aux


def _layers(cfg: LMConfig, params: Params, x, cos, sin, mode, cache=None,
            length=None):
    """Run every layer; returns (x, aux summed over the layers, fp32).
    In train mode under autograd with ``cfg.remat``, each layer runs
    inside ``torch.utils.checkpoint`` (non-reentrant): only its input is
    kept, and the backward recomputes the layer (the reference's
    ``jax.checkpoint`` with ``nothing_saveable``)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = mode == "train" and cfg.remat and torch.is_grad_enabled()
    for l, p in enumerate(_layer_params(params)):
        if remat:
            x, a = checkpoint(_layer, cfg, mode, l, p, x, cos, sin,
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
    x = params["embed"][tokens]
    cos, sin = rope_cos_sin(torch.arange(S, device=tokens.device),
                            cfg.head_dim, cfg.rope_theta)
    x, aux = _layers(cfg, params, x, cos, sin, "train")
    return rms_norm(x, params["final_ln"], cfg.norm_eps), aux


def _unembed_weight(cfg: LMConfig, params: Params):
    return params["embed"].T if cfg.tie_embeddings else params["unembed"]


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
    w = _unembed_weight(cfg, params)
    n_chunks = max(1, S // vocab_chunk_seq)
    hs = hidden.reshape(B, n_chunks, S // n_chunks, cfg.d_model)
    ls = labels.reshape(B, n_chunks, S // n_chunks)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(n_chunks):
        y = ls[:, c]
        logits = (hs[:, c] @ w).to(torch.float32)
        logz = torch.logsumexp(logits, dim=-1)
        # the gold logit of a masked label (< 0) is read at id 0 and
        # masked out below, as the reference's masked reduce drops it
        gold = torch.take_along_dim(
            logits, y.clamp_min(0).long()[..., None], dim=-1)[..., 0]
        mask = (y >= 0).to(torch.float32)
        total = total + torch.sum((logz - gold) * mask)
    n_tok = torch.clamp(torch.sum((labels >= 0).to(torch.float32)), min=1.0)
    return total / n_tok + aux_weight * aux / cfg.n_layers


@torch.inference_mode()
def prefill(cfg: LMConfig, params: Params, tokens: torch.Tensor,
            max_len: int | None = None):
    """Serving prefill: tokens (B, S) -> (last-position logits (B, V)
    fp32, KV cache with S positions filled of max(max_len, S)). Attends
    over the padded prompt, as the JAX prefill does."""
    B, S = tokens.shape
    dtype = params["embed"].dtype
    x = params["embed"][tokens]
    cos, sin = rope_cos_sin(torch.arange(S, device=tokens.device),
                            cfg.head_dim, cfg.rope_theta)
    S_max = max(S, max_len or 0)
    shape = (cfg.n_layers, B, S_max, cfg.n_kv_heads, cfg.head_dim)
    cache = {"k": torch.zeros(shape, dtype=dtype, device=tokens.device),
             "v": torch.zeros(shape, dtype=dtype, device=tokens.device)}
    x, _ = _layers(cfg, params, x, cos, sin, "prefill", cache=cache)
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    logits = x[:, -1] @ _unembed_weight(cfg, params)
    cache["length"] = torch.full((B,), S, dtype=torch.int32,
                                 device=tokens.device)
    return logits.to(torch.float32), cache


@torch.inference_mode()
def decode_step(cfg: LMConfig, params: Params, cache: Dict[str, Any],
                token: torch.Tensor):
    """One decode step. token (B,) -> (logits (B, V) fp32, cache). The
    cache's k/v are updated in place; the returned cache shares them
    and carries ``length + 1``."""
    x = params["embed"][token][:, None, :]                # (B, 1, d)
    pos = cache["length"]                                 # (B,)
    cos, sin = rope_cos_sin(pos[:, None], cfg.head_dim, cfg.rope_theta)
    x, _ = _layers(cfg, params, x, cos, sin, "decode", cache=cache,
                   length=pos)
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    logits = x[:, 0] @ _unembed_weight(cfg, params)
    new_cache = {"k": cache["k"], "v": cache["v"], "length": pos + 1}
    return logits.to(torch.float32), new_cache
