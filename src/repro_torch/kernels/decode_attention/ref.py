"""Naive oracle for GQA decode attention over a length-masked cache."""
from __future__ import annotations

import torch


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """q (B, H, D); caches (B, S, K, D); lengths (B,) valid positions.
    Returns (B, H, D) fp32."""
    B, H, D = q.shape
    K = k_cache.shape[2]
    G = H // K
    qg = q.to(torch.float32).reshape(B, K, G, D)
    s = torch.einsum("bkgd,bskd->bkgs", qg,
                     k_cache.to(torch.float32)) * D ** -0.5
    pos = torch.arange(k_cache.shape[1], device=q.device)
    valid = pos[None] < lengths.to(q.device)[:, None]         # (B, S)
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v_cache.to(torch.float32))
    return o.reshape(B, H, D)
