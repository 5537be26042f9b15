"""Wrapper of the hand-written CUDA IVF band scan (``csrc/ivf_scan.cu``).

Replaces the TPU kernel
``repro/kernels/ivf_scan/kernel.py:ivf_scan_kernel``. The source note in
``csrc/ivf_scan.cu`` says what bounds the kernel on an H100 and how its
design answers that.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0            # wrapper calls that launched the kernel


def check_band_layout(qn, cids, codes, scales, row_ids) -> None:
    """Raise unless the probe's inputs are what the kernels take: CUDA
    tensors on one device, contiguous, the packed IVF dtypes and shapes,
    d % 16 == 0 and 16-byte aligned codes."""
    want = (("qn", qn, torch.float32, 2), ("cids", cids, torch.int32, 2),
            ("codes", codes, torch.int8, 3),
            ("scales", scales, torch.float32, 2),
            ("row_ids", row_ids, torch.int32, 2))
    for name, t, dtype, dim in want:
        if t.device.type != "cuda" or t.device != qn.device:
            raise ValueError(f"{name} on {t.device}: want qn's CUDA device")
        if t.dtype != dtype or t.dim() != dim:
            raise TypeError(f"{name}: {t.dtype} {tuple(t.shape)}, want "
                            f"{dtype} with {dim} dims")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    K, cap, d = codes.shape
    if qn.shape[1] != d or cids.shape[0] != qn.shape[0] \
            or scales.shape != (K, cap) or row_ids.shape != (K, cap):
        raise ValueError(f"shapes qn {tuple(qn.shape)}, cids "
                         f"{tuple(cids.shape)}, codes {tuple(codes.shape)}, "
                         f"scales {tuple(scales.shape)}, row_ids "
                         f"{tuple(row_ids.shape)} do not fit")
    if d % 16 or codes.data_ptr() % 16:
        raise ValueError(f"d={d}: the kernel takes d % 16 == 0 and "
                         "16-byte aligned codes")


def ivf_scan(qn: torch.Tensor, cids: torch.Tensor, codes: torch.Tensor,
             scales: torch.Tensor, row_ids: torch.Tensor,
             n_candidates: int):
    """Scan the probed bands on the card. qn (B, d) fp32 L2-normalized;
    cids (B, nprobe) int32 cluster ids in [0, K); codes (K, cap, d)
    int8; scales (K, cap) fp32; row_ids (K, cap) int32 (-1 = pad).
    Returns ((B, C) fp32 approx scores, (B, C) int32 global row ids) in
    (score desc, id asc) order; absent candidates are (NEG, -1). One
    launch, no scratch; the launch raises if the shape's lists do not
    fit a block's shared memory."""
    global launches
    check_band_layout(qn, cids, codes, scales, row_ids)
    B, nprobe = cids.shape
    _, cap, d = codes.shape
    C = int(n_candidates)
    if not 1 <= C <= nprobe * cap:
        raise ValueError(f"n_candidates={C} outside [1, nprobe * cap = "
                         f"{nprobe * cap}]")
    out_v = torch.empty((B, C), dtype=torch.float32, device=qn.device)
    out_i = torch.empty((B, C), dtype=torch.int32, device=qn.device)
    if B == 0:
        return out_v, out_i
    stream = torch.cuda.current_stream(qn.device).cuda_stream
    _build.launch("ivf_scan_topc", qn.device, qn.data_ptr(),
                  cids.data_ptr(), codes.data_ptr(), scales.data_ptr(),
                  row_ids.data_ptr(), B, nprobe, cap, d, C,
                  out_v.data_ptr(), out_i.data_ptr(), stream)
    launches += 1
    return out_v, out_i
