"""Wrapper of the hand-written CUDA decode-attention kernel
(``csrc/decode_attention.cu``), which replaces the TPU kernel
``repro/kernels/decode_attention/kernel.py:decode_attention``. The
source note there says what bounds it on an H100 and how its design
answers that."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (64, 128)
# query heads a block carries (the group G = H / K, rounded up to one of
# these, or split into head tiles of the largest): bf16 carries them as
# the rows of the m16 mma, fp32 in registers
HEAD_TILES = {torch.bfloat16: (1, 2, 4, 8, 16), torch.float32: (1, 2, 4, 8)}
CHUNK = 128             # keys per block (one split of the cache)
launches = 0            # kernel launches, counted by the wrapper
# zeroed int32 ticket counters, one per (batch, kv head), for each
# (device, stream): the kernel leaves them zero after every call
_tickets: dict = {}


def _ticket_buffer(device: torch.device, stream: int, n: int):
    key = (device.index, stream)
    buf = _tickets.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
        _tickets[key] = buf
    return buf


def heads_per_block(G: int, dtype: torch.dtype) -> int:
    """The smallest head tile that holds the group ``G``, else the
    largest (G then splits into ceil(G / tile) blocks of heads)."""
    tiles = HEAD_TILES[dtype]
    return next((t for t in tiles if t >= G), tiles[-1])


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """One new token per sequence over its KV cache, on the card.
    q (B, H, D); caches (B, S, K, D); lengths (B,) int32 valid positions
    (at most S; 0 gives a zero output). Contiguous CUDA tensors; q and
    the caches share one dtype (bf16 or fp32). Any G = H / K. Each CHUNK
    keys of the cache go to one block (one split) per head tile of each
    kv head. Returns (B, H, D) in q.dtype.
    ``lengths`` is never read on the host."""
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
    if H % K or D not in HEAD_DIMS:
        raise ValueError(f"H={H}, K={K}, D={D}: want H % K == 0 and D in "
                         f"{HEAD_DIMS}")
    gt = heads_per_block(H // K, q.dtype)
    slots = K * -(-(H // K) // gt)          # blocks along kv head x tile
    if slots > 65535:
        raise ValueError(f"K x head tiles = {slots} > 65535 blocks")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("decode kernel needs 16-byte aligned caches")
    out = torch.empty_like(q)
    if B == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    # per split of each (batch, kv head, head tile): gt x D partial
    # outputs, then gt maxima and gt sums, fp32
    n_split = -(-S // CHUNK)
    part = torch.empty(B * slots * n_split * gt * (D + 2),
                       dtype=torch.float32, device=q.device)
    tickets = _ticket_buffer(q.device, stream, B * slots)
    _build.launch("decode_attention_fwd", q.device, q.data_ptr(),
                  k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
                  out.data_ptr(), part.data_ptr(), tickets.data_ptr(), B, S,
                  H, K, D, gt, CHUNK, D ** -0.5,
                  int(q.dtype == torch.bfloat16), stream)
    launches += 1
    return out
