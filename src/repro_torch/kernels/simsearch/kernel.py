"""Wrapper of the hand-written CUDA simsearch kernel (``csrc/simsearch.cu``).

Replaces the TPU kernel ``repro/kernels/simsearch/kernel.py:simsearch``.
The source note in ``csrc/simsearch.cu`` says what bounds the kernel on
an H100 and how its design answers that.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

MAX_K = 32
MAX_QUERIES = 32        # query rows per launch; larger batches are chunked
MAX_D = 1024
launches = 0            # kernel launches (one per chunk of query rows)


def simsearch(queries: torch.Tensor, corpus: torch.Tensor, k: int = 1):
    """Fused cosine top-k on the card. queries (B, d), corpus (N, d),
    both fp32 CUDA tensors, contiguous. Returns ((B, k) fp32 scores,
    (B, k) int32 indices), ordered by (score desc, index asc).

    The corpus is scanned as it is: the kernel masks the ragged last
    tile itself, so nothing is padded or copied."""
    global launches
    if queries.device.type != "cuda" or corpus.device.type != "cuda":
        raise ValueError("simsearch kernel takes CUDA tensors")
    if queries.device != corpus.device:
        raise ValueError(f"queries on {queries.device}, corpus on "
                         f"{corpus.device}")
    if queries.dtype != torch.float32 or corpus.dtype != torch.float32:
        raise TypeError(f"simsearch kernel takes fp32, got "
                        f"{queries.dtype}/{corpus.dtype}")
    if queries.dim() != 2 or corpus.dim() != 2 \
            or queries.shape[1] != corpus.shape[1]:
        raise ValueError(f"shapes {tuple(queries.shape)} vs "
                         f"{tuple(corpus.shape)}: want (B, d), (N, d)")
    if not (queries.is_contiguous() and corpus.is_contiguous()):
        raise ValueError("simsearch kernel takes contiguous tensors")
    B, d = queries.shape
    N = corpus.shape[0]
    if d % 4 or d > MAX_D:
        raise ValueError(f"d={d}: the kernel takes d % 4 == 0, d <= "
                         f"{MAX_D}")
    if not 1 <= k <= min(MAX_K, N):
        raise ValueError(f"k={k} outside [1, min({MAX_K}, N={N})]")
    if corpus.data_ptr() % 16 or queries.data_ptr() % 16:
        raise ValueError("simsearch kernel needs 16-byte aligned tensors")
    out_v = torch.empty((B, k), dtype=torch.float32, device=queries.device)
    out_i = torch.empty((B, k), dtype=torch.int32, device=queries.device)
    if B == 0:
        return out_v, out_i
    sms = torch.cuda.get_device_properties(queries.device) \
        .multi_processor_count
    n_blocks = max(1, min(-(-N // 256), 2 * sms))
    qb = min(B, MAX_QUERIES)
    part_v = torch.empty((qb * n_blocks * k,), dtype=torch.float32,
                         device=queries.device)
    part_i = torch.empty((qb * n_blocks * k,), dtype=torch.int32,
                         device=queries.device)
    stream = torch.cuda.current_stream(queries.device).cuda_stream
    for b0 in range(0, B, MAX_QUERIES):
        nb = min(MAX_QUERIES, B - b0)
        _build.launch("simsearch_topk", queries[b0].data_ptr(),
                      corpus.data_ptr(), nb, N, d, k, n_blocks,
                      part_v.data_ptr(), part_i.data_ptr(),
                      out_v[b0].data_ptr(), out_i[b0].data_ptr(), stream)
        launches += 1
    return out_v, out_i
