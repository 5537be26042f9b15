"""Wrapper of the hand-written CUDA embedding bag
(``csrc/embedding_bag.cu``).

Replaces the TPU kernel
``repro/kernels/embedding_bag/kernel.py:embedding_bag``. The source note
in ``csrc/embedding_bag.cu`` says what bounds the kernel on an H100 (the
gathered rows' bytes, and how many of them come from HBM rather than
L2) and how its design answers that.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
launches = 0            # wrapper calls that launched the kernel


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  weights: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """Gather and weighted reduce on the card: table (V, d) fp32 or
    bf16; ids (B, m) int32; weights (B, m) fp32; all CUDA tensors on one
    device, contiguous. Returns (B, d) fp32 = sum_j weights[b, j] *
    table[ids[b, j]], accumulated in j order from zero with one rounding
    per multiply and per add (bit-identical to ``embedding_bag_ref``).

    ``groups`` (dividing B) says that bag ``b * groups + g`` belongs to
    group g (Wide&Deep: B rows x F fields, groups = F). When the table
    and the rows the call gathers are both larger than half the card's
    L2, the kernel then takes the bags group by group, so one group's
    rows stay in L2 while its bags run; the output does not change.

    Every id must lie in [0, V): that is the caller's contract, as on
    the TPU, and it is not checked here (a check would cost a host sync
    per call on the serve path)."""
    global launches
    for name, t in (("table", table), ("ids", ids), ("weights", weights)):
        if t.device.type != "cuda" or t.device != table.device:
            raise ValueError(f"{name} on {t.device}: want table's CUDA "
                             "device")
        if t.dim() != 2:
            raise ValueError(f"{name}: {tuple(t.shape)}, want 2 dims")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if table.dtype not in DTYPES or ids.dtype != torch.int32 \
            or weights.dtype != torch.float32:
        raise TypeError(f"table {table.dtype}, ids {ids.dtype}, weights "
                        f"{weights.dtype}: want fp32 or bf16, int32, fp32")
    if weights.shape != ids.shape:
        raise ValueError(f"weights {tuple(weights.shape)} vs ids "
                         f"{tuple(ids.shape)}")
    (V, d), (B, m) = table.shape, ids.shape
    if V < 1 or d < 1 or B >= 2 ** 31:
        raise ValueError(f"table {tuple(table.shape)}, ids "
                         f"{tuple(ids.shape)}: want V, d >= 1 and "
                         "B < 2**31")
    if groups < 1 or B % groups:
        raise ValueError(f"groups={groups} must divide B={B}")
    for name, t in (("table", table), ("ids", ids), ("weights", weights)):
        if t.data_ptr() % t.element_size():
            raise ValueError(f"{name} is not aligned to its element size")
    out = torch.empty((B, d), dtype=torch.float32, device=table.device)
    if B == 0:
        return out
    l2 = torch.cuda.get_device_properties(table.device).L2_cache_size
    row = d * table.element_size()
    order = groups if min(V, B * m) * row > l2 // 2 else 1
    stream = torch.cuda.current_stream(table.device).cuda_stream
    _build.launch("embedding_bag_fwd", table.device, table.data_ptr(),
                  ids.data_ptr(), weights.data_ptr(), out.data_ptr(), B, m,
                  d, DTYPES[table.dtype], order, stream)
    launches += 1
    return out
