"""Naive oracles for causal GQA flash attention (fp32): the output, its
log-sum-exp and the backward."""
from __future__ import annotations

import torch


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(B, K, G, S, S) fp32 scaled scores, -inf above the diagonal."""
    B, S, H, D = q.shape
    K = k.shape[2]
    qg = q.to(torch.float32).reshape(B, S, K, H // K, D)
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.to(torch.float32))
    s = s * D ** -0.5
    mask = torch.tril(torch.ones((S, S), dtype=torch.bool, device=q.device))
    return s.masked_fill(~mask, float("-inf"))


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """q (B, S, H, D); k, v (B, S, K, D); returns (B, S, H, D) fp32."""
    B, S, H, D = q.shape
    p = torch.softmax(_scores(q, k), dim=-1)
    o = torch.einsum("bkgst,btkd->bskgd", p, v.to(torch.float32))
    return o.reshape(B, S, H, D)


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Each row's natural log-sum-exp of its scaled, causally masked
    scores: (B, H, S) fp32, the forward kernel's ``return_lse``."""
    B, S, H, _ = q.shape
    return torch.logsumexp(_scores(q, k), dim=-1).reshape(B, H, S)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            lse: torch.Tensor, dout: torch.Tensor):
    """The backward kernel's formulas in fp32: P = exp(scores - lse),
    dV = P^T dO, dP = dO V^T, delta = rowsum(dO * O), dS = P * (dP -
    delta), dQ = dS K * scale, dK = dS^T Q * scale. q, o, dout (B, S, H,
    D); k, v (B, S, K, D); lse (B, H, S). Returns (dq, dk, dv) fp32."""
    B, S, H, D = q.shape
    K = k.shape[2]
    G = H // K
    f32 = torch.float32
    qg = q.to(f32).reshape(B, S, K, G, D)
    dog = dout.to(f32).reshape(B, S, K, G, D)
    p = torch.exp(_scores(q, k) - lse.reshape(B, K, G, S, 1))
    dv = torch.einsum("bkgst,bskgd->btkd", p, dog)
    dp = torch.einsum("bskgd,btkd->bkgst", dog, v.to(f32))
    delta = (dout.to(f32) * o.to(f32)).sum(-1)                  # (B, S, H)
    delta = delta.reshape(B, S, K, G).permute(0, 2, 3, 1)[..., None]
    ds = p * (dp - delta) * D ** -0.5
    dq = torch.einsum("bkgst,btkd->bskgd", ds, k.to(f32))
    dk = torch.einsum("bkgst,bskgd->btkd", ds, qg)
    return dq.reshape(B, S, H, D), dk, dv
