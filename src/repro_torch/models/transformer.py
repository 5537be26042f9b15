"""Decoder-only LM, dense path (port of ``repro/models/transformer.py``).

Entry points (functions of (cfg, params, inputs)):

- ``init_params(cfg, generator, device)`` -> dict (layer weights stacked
  on a leading L axis, as the JAX pytree)
- ``params_from_numpy(cfg, tree, device)`` -> the same dict from the JAX
  parameter pytree given as numpy arrays
- ``prefill(cfg, params, tokens, max_len)`` -> (last-token logits, cache)
- ``decode_step(cfg, params, cache, token)`` -> (logits, cache)

KV cache layout: dict(k=(L, B, S, Kv, D), v=(L, B, S, Kv, D),
length=(B,)). Attention goes through ``kernels/flash_attention``
(prefill) and ``kernels/decode_attention`` (decode): the CUDA kernels on
the card, their plain versions on the CPU. The JAX model calls the jnp
twins at ``transformer.py:125/128`` instead of its Pallas kernels.
Layers run unrolled (PyTorch is eager; there is no scan to compile).
MoE configs are not ported yet (ROADMAP.md, queue 1).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import LMConfig
from repro_torch.device import get_device
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.models.layers import (apply_rope, dense_init, embed_init,
                                       rms_norm, rope_cos_sin, swiglu)

Params = Dict[str, Any]


def _check_dense(cfg: LMConfig) -> None:
    if cfg.is_moe:
        raise NotImplementedError(
            f"{cfg.name} is MoE; the port has the dense path only "
            "(ROADMAP.md, queue 1, 'remaining workloads')")


def _layer_shapes(cfg: LMConfig):
    d, h = cfg.d_model, cfg.head_dim
    shapes = {
        "wq": (d, cfg.n_heads * h),
        "wk": (d, cfg.n_kv_heads * h),
        "wv": (d, cfg.n_kv_heads * h),
        "wo": (cfg.n_heads * h, d),
        "ln1": (d,),
        "ln2": (d,),
        "wg": (d, cfg.d_ff), "wu": (d, cfg.d_ff), "wd": (cfg.d_ff, d),
    }
    if cfg.qk_norm:
        shapes["q_norm"] = (h,)
        shapes["k_norm"] = (h,)
    return shapes


def init_params(cfg: LMConfig, generator: torch.Generator | None = None,
                device=None) -> Params:
    """Random weights in ``cfg.dtype`` on ``device`` (default ``cuda``),
    with the distributions of the JAX ``init_params`` (truncated-normal
    fan-in dense weights, truncated-normal embeddings, unit norms). The
    draws come from ``generator`` and differ from JAX's."""
    _check_dense(cfg)
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
    _check_dense(cfg)
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


def _attention_block(cfg: LMConfig, p: Params, l: int, x, cos, sin, mode,
                     cache=None, length=None):
    """Attention sub-block of layer ``l``. x (B, S, d). In decode mode the
    new token's k/v are written into the cache IN PLACE at the uniform
    position ``length[0]`` (the JAX model rewrites the whole cache with a
    one-hot ``where``)."""
    B, S, _ = x.shape
    h = cfg.head_dim
    q = (x @ p["wq"][l]).reshape(B, S, cfg.n_heads, h)
    k = (x @ p["wk"][l]).reshape(B, S, cfg.n_kv_heads, h)
    v = (x @ p["wv"][l]).reshape(B, S, cfg.n_kv_heads, h)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"][l], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"][l], cfg.norm_eps)
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
    return o.reshape(B, S, cfg.n_heads * h) @ p["wo"][l]


def _layers(cfg: LMConfig, params: Params, x, cos, sin, mode, cache=None,
            length=None):
    p = params["layers"]
    for l in range(cfg.n_layers):
        x = x + _attention_block(cfg, p, l, rms_norm(x, p["ln1"][l],
                                                     cfg.norm_eps),
                                 cos, sin, mode, cache, length)
        x = x + swiglu(rms_norm(x, p["ln2"][l], cfg.norm_eps),
                       p["wg"][l], p["wu"][l], p["wd"][l])
    return x


def _unembed_weight(cfg: LMConfig, params: Params):
    return params["embed"].T if cfg.tie_embeddings else params["unembed"]


@torch.inference_mode()
def prefill(cfg: LMConfig, params: Params, tokens: torch.Tensor,
            max_len: int | None = None):
    """Serving prefill: tokens (B, S) -> (last-position logits (B, V)
    fp32, KV cache with S positions filled of max(max_len, S)). Attends
    over the padded prompt, as the JAX prefill does."""
    _check_dense(cfg)
    B, S = tokens.shape
    dtype = params["embed"].dtype
    x = params["embed"][tokens]
    cos, sin = rope_cos_sin(torch.arange(S, device=tokens.device),
                            cfg.head_dim, cfg.rope_theta)
    S_max = max(S, max_len or 0)
    shape = (cfg.n_layers, B, S_max, cfg.n_kv_heads, cfg.head_dim)
    cache = {"k": torch.zeros(shape, dtype=dtype, device=tokens.device),
             "v": torch.zeros(shape, dtype=dtype, device=tokens.device)}
    x = _layers(cfg, params, x, cos, sin, "prefill", cache=cache)
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
    _check_dense(cfg)
    x = params["embed"][token][:, None, :]                # (B, 1, d)
    pos = cache["length"]                                 # (B,)
    cos, sin = rope_cos_sin(pos[:, None], cfg.head_dim, cfg.rope_theta)
    x = _layers(cfg, params, x, cos, sin, "decode", cache=cache, length=pos)
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    logits = x[:, 0] @ _unembed_weight(cfg, params)
    new_cache = {"k": cache["k"], "v": cache["v"], "length": pos + 1}
    return logits.to(torch.float32), new_cache
