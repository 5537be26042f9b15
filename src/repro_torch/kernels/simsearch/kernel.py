"""Wrapper of the hand-written CUDA simsearch kernel (``csrc/simsearch.cu``).

Replaces the TPU kernel ``repro/kernels/simsearch/kernel.py:simsearch``.
The source note in ``csrc/simsearch.cu`` says what bounds the kernel on
an H100 and how its design answers that.
"""
from __future__ import annotations

import torch

from repro_torch.analysis import kernel_costs
from repro_torch.kernels import _build

MAX_K = 32
MAX_QUERIES = 32        # query rows per launch; larger batches are chunked
MAX_D = 1024
TILE_ROWS = 128         # corpus rows a block stages and screens at once
H100_SMS = 132          # the SMs a meta call assumes (blocks a launch)
launches = 0            # kernel launches (one per chunk of query rows)
# the kernel's global screening thresholds, MAX_QUERIES int32 words per
# (device, stream), each the order-preserving key of -inf (0x807fffff)
# between calls: the kernel's merge resets them
THRESHOLD_INIT = (0xff800000 ^ 0x7fffffff) - 2 ** 32
_thresholds: dict = {}


def _threshold_buffer(device: torch.device, stream: int) -> torch.Tensor:
    key = (device.index, stream)
    if key not in _thresholds:
        _thresholds[key] = torch.full((MAX_QUERIES,), THRESHOLD_INIT,
                                      dtype=torch.int32, device=device)
    return _thresholds[key]


def _allocate(B: int, N: int, k: int, device, sms: int):
    """The call's outputs, (B, k) fp32 scores and int32 indices, and for
    B > 0 its workspace: each block's top-k for each query of a launch,
    fp32 and int32, with one persistent block per SM, each over a
    stride of TILE_ROWS-row tiles (its shared memory leaves room for one
    block an SM). Returns (out_v, out_i, part_v, part_i, n_blocks)."""
    out_v = torch.empty((B, k), dtype=torch.float32, device=device)
    out_i = torch.empty((B, k), dtype=torch.int32, device=device)
    if B == 0:
        return out_v, out_i, None, None, 0
    n_blocks = max(1, min(-(-N // TILE_ROWS), sms))
    qb = min(B, MAX_QUERIES)
    part_v = torch.empty((qb * n_blocks * k,), dtype=torch.float32,
                         device=device)
    part_i = torch.empty((qb * n_blocks * k,), dtype=torch.int32,
                         device=device)
    return out_v, out_i, part_v, part_i, n_blocks


def simsearch_meta(queries: torch.Tensor, corpus: torch.Tensor, k: int):
    """The kernel's meta branch: its outputs and workspace (for an
    H100's SMs) on the meta device, and its cost
    (``kernel_costs.simsearch``) reported to an active
    ``ProgramCounter``. The plain version never runs."""
    (B, d), N = queries.shape, corpus.shape[0]
    out_v, out_i, *_ = _allocate(B, N, k, queries.device, H100_SMS)
    if B:
        kernel_costs.record("simsearch", kernel_costs.simsearch(B, N, d, k))
    return out_v, out_i


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
    sms = torch.cuda.get_device_properties(queries.device) \
        .multi_processor_count
    out_v, out_i, part_v, part_i, n_blocks = _allocate(
        B, N, k, queries.device, sms)
    if B == 0:
        return out_v, out_i
    stream = torch.cuda.current_stream(queries.device).cuda_stream
    gthr = _threshold_buffer(queries.device, stream)
    for b0 in range(0, B, MAX_QUERIES):
        nb = min(MAX_QUERIES, B - b0)
        _build.launch("simsearch_topk", queries.device,
                      queries[b0].data_ptr(), corpus.data_ptr(), nb, N, d,
                      k, n_blocks,
                      part_v.data_ptr(), part_i.data_ptr(), gthr.data_ptr(),
                      out_v[b0].data_ptr(), out_i[b0].data_ptr(), stream)
        launches += 1
    return out_v, out_i
