"""Wrapper of the hand-written CUDA fused two-tier probe
(``csrc/fused_serve.cu``).

Replaces the TPU kernel
``repro/kernels/fused_serve/kernel.py:fused_serve_kernel``. The source
note in ``csrc/fused_serve.cu`` says what bounds the kernel on an H100
and how its design answers that.
"""
from __future__ import annotations

import torch

from repro_torch.analysis import kernel_costs
from repro_torch.kernels import _build
from repro_torch.kernels.ivf_scan.kernel import check_band_layout

launches = 0            # wrapper calls that launched the kernel


def _outputs(B: int, C: int, Cd: int, device):
    """(B, C) static scores and row ids, (B, Cd) dyn scores and slots:
    fp32 and int32."""
    return (torch.empty((B, C), dtype=torch.float32, device=device),
            torch.empty((B, C), dtype=torch.int32, device=device),
            torch.empty((B, Cd), dtype=torch.float32, device=device),
            torch.empty((B, Cd), dtype=torch.int32, device=device))


def fused_serve_meta(qn: torch.Tensor, cids: torch.Tensor,
                     codes: torch.Tensor, tiles: torch.Tensor,
                     n_candidates: int, n_dyn_candidates: int):
    """The kernel's meta branch: its outputs on the meta device (the
    kernel allocates nothing else), and its cost
    (``kernel_costs.fused_serve``, the probed bands counted as distinct,
    at most K) reported to an active ``ProgramCounter``."""
    (B, nprobe), (K, cap, d) = cids.shape, codes.shape
    C, Cd = int(n_candidates), int(n_dyn_candidates)
    out = _outputs(B, C, Cd, qn.device)
    if B:
        kernel_costs.record("fused_serve", kernel_costs.fused_serve(
            B, nprobe, cap, d, C, Cd, min(K, B * nprobe),
            tiles.shape[0] * tiles.shape[1]))
    return out


def fused_serve(qn: torch.Tensor, cids: torch.Tensor, codes: torch.Tensor,
                scales: torch.Tensor, row_ids: torch.Tensor,
                tiles: torch.Tensor, tile_ids: torch.Tensor,
                n_candidates: int, n_dyn_candidates: int):
    """Both tiers' candidates for a micro-batch, in one launch on the
    card, with no scratch. The launch raises if the two candidate lists
    do not fit a block's shared memory (C and Cd both in the thousands).

    qn (B, d) fp32 L2-normalized; cids (B, nprobe) int32 in [0, K);
    codes (K, cap, d) int8; scales (K, cap) fp32; row_ids (K, cap) int32
    (-1 = pad); tiles (T, tile, d) bf16 dynamic-tier rows; tile_ids
    (T, tile) int32 slot ids (-1 = invalid or pad).
    Returns (static scores (B, C), static row ids (B, C), dyn scores
    (B, Cd), dyn slots (B, Cd)), each pair in (score desc, id asc)
    order with absent candidates as (NEG, -1)."""
    global launches
    check_band_layout(qn, cids, codes, scales, row_ids)
    for name, t, dtype, dim in (("tiles", tiles, torch.bfloat16, 3),
                                ("tile_ids", tile_ids, torch.int32, 2)):
        if t.device != qn.device:
            raise ValueError(f"{name} on {t.device}: want {qn.device}")
        if t.dtype != dtype or t.dim() != dim:
            raise TypeError(f"{name}: {t.dtype} {tuple(t.shape)}, want "
                            f"{dtype} with {dim} dims")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    B, nprobe = cids.shape
    _, cap, d = codes.shape
    T, tile, dt = tiles.shape
    if dt != d or tile_ids.shape != (T, tile) or T < 1 or tile < 1:
        raise ValueError(f"tiles {tuple(tiles.shape)}, tile_ids "
                         f"{tuple(tile_ids.shape)} do not fit d={d}")
    if tiles.data_ptr() % 16:
        raise ValueError("the kernel takes 16-byte aligned tiles")
    C, Cd = int(n_candidates), int(n_dyn_candidates)
    if not 1 <= C <= nprobe * cap or not 1 <= Cd <= T * tile:
        raise ValueError(f"C={C}, Cd={Cd} outside [1, {nprobe * cap}], "
                         f"[1, {T * tile}]")
    dev = qn.device
    sv, si, dv, di = _outputs(B, C, Cd, dev)
    if B == 0:
        return sv, si, dv, di
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.launch("fused_serve_topc", dev, qn.data_ptr(), cids.data_ptr(),
                  codes.data_ptr(), scales.data_ptr(), row_ids.data_ptr(),
                  tiles.data_ptr(), tile_ids.data_ptr(), B, nprobe, cap, T,
                  tile, d, C, Cd, sv.data_ptr(), si.data_ptr(),
                  dv.data_ptr(), di.data_ptr(), stream)
    launches += 1
    return sv, si, dv, di
