"""Naive oracle for causal GQA flash attention (fp32)."""
from __future__ import annotations

import torch


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """q (B, S, H, D); k, v (B, S, K, D); returns (B, S, H, D) fp32."""
    B, S, H, D = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.to(torch.float32).reshape(B, S, K, G, D)
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.to(torch.float32))
    s = s * D ** -0.5
    mask = torch.tril(torch.ones((S, S), dtype=torch.bool, device=q.device))
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,btkd->bskgd", p, v.to(torch.float32))
    return o.reshape(B, S, H, D)
