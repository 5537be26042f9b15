"""Plain PyTorch attention: the plain versions of the flash-attention
and decode-attention kernels (port of ``repro/models/attention.py``).

Shapes use the GQA layout throughout: q (B, S, H, D), k/v (B, S, K, D)
with H = K * G query heads; query head h reads kv head h // G. Both
compute in fp32 and return q.dtype. On the card the model calls the
CUDA kernels instead (``kernels/flash_attention``,
``kernels/decode_attention``).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def causal_attention(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """Exact causal GQA attention. q (B, S, H, D); k, v (B, S, K, D) ->
    (B, S, H, D) in q.dtype."""
    B, S, H, D = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.to(torch.float32).reshape(B, S, K, G, D)
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.to(torch.float32)) \
        * D ** -0.5
    mask = torch.tril(torch.ones((S, S), dtype=torch.bool, device=q.device))
    # a scalar fill: no host-to-device copy (which would sync the stream)
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,btkd->bskgd", p, v.to(torch.float32))
    return o.reshape(B, S, H, D).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     length: torch.Tensor) -> torch.Tensor:
    """One-step GQA decode: q (B, 1, H, D) vs caches (B, S, K, D).
    ``length`` (scalar or (B,)) is the number of valid cache positions;
    entries at index >= length are masked, and a sequence of length 0
    attends to nothing and gives 0, as the CUDA kernel does (the JAX
    twin averages the whole cache there, its Pallas kernel gives NaN).
    Returns (B, 1, H, D) in q.dtype."""
    B, _, H, D = q.shape
    K = k_cache.shape[2]
    G = H // K
    qg = q.to(torch.float32).reshape(B, K, G, D)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.to(torch.float32)) \
        * D ** -0.5
    pos = torch.arange(k_cache.shape[1], device=q.device)
    valid = pos[None, :] < torch.reshape(length, (-1, 1))      # (B, S)
    s = torch.where(valid[:, None, None, :], s,
                    torch.tensor(NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1) \
        * (torch.reshape(length, (-1,)) > 0)[:, None, None, None]
    o = torch.einsum("bkgs,bskd->bkgd", p, v_cache.to(torch.float32))
    return o.reshape(B, 1, H, D).to(q.dtype)
