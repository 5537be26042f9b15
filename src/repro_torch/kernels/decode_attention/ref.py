"""Naive oracles for GQA decode attention over a length-masked cache:
the one-pass softmax, and the split-KV form the CUDA kernel computes."""
from __future__ import annotations

import torch


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """q (B, H, D); caches (B, S, K, D); lengths (B,) valid positions.
    Returns (B, H, D) fp32; a sequence of length 0 gives 0."""
    B, H, D = q.shape
    K = k_cache.shape[2]
    G = H // K
    qg = q.to(torch.float32).reshape(B, K, G, D)
    s = torch.einsum("bkgd,bskd->bkgs", qg,
                     k_cache.to(torch.float32)) * D ** -0.5
    pos = torch.arange(k_cache.shape[1], device=q.device)
    valid = pos[None] < lengths.to(q.device)[:, None]         # (B, S)
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1).nan_to_num(0.0)              # length 0
    o = torch.einsum("bkgs,bskd->bkgd", p, v_cache.to(torch.float32))
    return o.reshape(B, H, D)


def decode_attention_split_ref(q: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor, lengths: torch.Tensor,
                               chunk: int) -> torch.Tensor:
    """The kernel's split-KV schedule in plain PyTorch: each ``chunk``
    of cache positions gives a partial (m, l, o) -- its score maximum,
    its sum of exp(s - m) and its unnormalised output -- and the
    partials merge in split order. Chunks at or past ``lengths[b]``
    are empty (l = 0) and drop out; length 0 gives 0. Shapes as
    :func:`decode_attention_ref`; returns (B, H, D) fp32."""
    B, H, D = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    G = H // K
    n = -(-S // chunk)
    pad = n * chunk - S
    kc, vc = (torch.nn.functional.pad(c.to(torch.float32),
                                      (0, 0, 0, 0, 0, pad))
              .reshape(B, n, chunk, K, D) for c in (k_cache, v_cache))
    qg = q.to(torch.float32).reshape(B, K, G, D)
    s = torch.einsum("bkgd,bnckd->bnkgc", qg, kc) * D ** -0.5
    pos = torch.arange(n * chunk, device=q.device).reshape(n, chunk)
    valid = pos[None] < lengths.to(q.device)[:, None, None]   # (B, n, c)
    s = s.masked_fill(~valid[:, :, None, None, :], float("-inf"))
    m = s.amax(-1)                                            # (B,n,K,G)
    live = valid.any(-1)[:, :, None, None]                    # (B,n,1,1)
    p = torch.exp(s - torch.where(live, m, 0.0)[..., None])
    l_part = p.sum(-1)                                        # 0 if empty
    o_part = torch.einsum("bnkgc,bnckd->bnkgd", p, vc)
    # merge in split order
    m_all = torch.where(live, m, float("-inf")).amax(1)       # (B,K,G)
    l_sum = torch.zeros_like(l_part[:, 0])
    o_sum = torch.zeros_like(o_part[:, 0])
    for i in range(n):
        f = torch.where(live[:, i], torch.exp(m[:, i] - m_all), 0.0)
        l_sum = l_sum + l_part[:, i] * f
        o_sum = o_sum + o_part[:, i] * f[..., None]
    o = torch.where(l_sum[..., None] > 0,
                    o_sum / l_sum.clamp_min(1e-30)[..., None], 0.0)
    return o.reshape(B, H, D)
