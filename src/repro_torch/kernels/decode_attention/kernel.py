"""Wrapper of the hand-written CUDA decode-attention kernel
(``csrc/decode_attention.cu``), which replaces the TPU kernel
``repro/kernels/decode_attention/kernel.py:decode_attention``. The
source note there says what bounds it on an H100 and how its design
answers that."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (64, 128)
GROUPS = (1, 2, 4, 8)
launches = 0            # kernel launches, counted by the wrapper


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """One new token per sequence over its KV cache, on the card.
    q (B, H, D); caches (B, S, K, D); lengths (B,) int32 valid positions
    (at most S). Contiguous CUDA tensors; q and the caches share one
    dtype (bf16 or fp32). Returns (B, H, D) in q.dtype."""
    global launches
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("lengths", lengths)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} on {t.device}: want q's CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if q.dtype not in (torch.bfloat16, torch.float32) \
            or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(f"decode kernel takes one dtype, bf16 or fp32: "
                        f"{q.dtype}/{k_cache.dtype}/{v_cache.dtype}")
    if lengths.dtype != torch.int32:
        raise TypeError(f"lengths must be int32, got {lengths.dtype}")
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape \
            or k_cache.shape[0] != q.shape[0] \
            or k_cache.shape[3] != q.shape[2] \
            or tuple(lengths.shape) != (q.shape[0],):
        raise ValueError(f"shapes q {tuple(q.shape)}, caches "
                         f"{tuple(k_cache.shape)}, lengths "
                         f"{tuple(lengths.shape)}")
    B, H, D = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    if H % K or H // K not in GROUPS or D not in HEAD_DIMS:
        raise ValueError(f"H={H}, K={K}, D={D}: want G = H/K in {GROUPS} "
                         f"and D in {HEAD_DIMS}")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("decode kernel needs 16-byte aligned caches")
    out = torch.empty_like(q)
    if B == 0:
        return out
    _build.launch("decode_attention_fwd", q.data_ptr(), k_cache.data_ptr(),
                  v_cache.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                  B, S, H, K, D, D ** -0.5, int(q.dtype == torch.bfloat16),
                  torch.cuda.current_stream(q.device).cuda_stream)
    launches += 1
    return out
