"""Wrapper of the hand-written CUDA embedding-bag backward
(``embedding_bag_bwd`` in ``csrc/embedding_bag.cu``).

It replaces no TPU kernel: the JAX package differentiates its jnp bag
(``repro/models/recsys.py:42-51``, ``jax.ops.segment_sum``). The source
note says what bounds it on an H100 and how its design answers that:
the flat ids are sorted stably on the card, and a sub-warp owns each
gradient row, adds its terms in ascending flat position and writes the
row once, so the result has no atomics and is the same bits every run.
"""
from __future__ import annotations

import torch

from repro_torch.analysis import kernel_costs
from repro_torch.kernels import _build

launches = 0            # wrapper calls that launched the kernel


def _prepare(ids: torch.Tensor, n_rows: int, d: int):
    """The index (the flat ids sorted stably: keys and their flat
    positions) and the (n_rows, d) fp32 gradient to write."""
    keys, pos = torch.sort(ids.reshape(-1), stable=True)
    return keys, pos, torch.empty((n_rows, d), dtype=torch.float32,
                                  device=ids.device)


def embedding_bag_backward_meta(grad: torch.Tensor, ids: torch.Tensor,
                                n_rows: int) -> torch.Tensor:
    """The kernel's meta branch: its index preparation (the sort runs op
    for op) and its gradient on the meta device, and its cost
    (``kernel_costs.embedding_bag_backward``) reported to an active
    ``ProgramCounter``."""
    (B, d), m = grad.shape, ids.shape[1]
    _, _, out = _prepare(ids, n_rows, d)
    kernel_costs.record("embedding_bag_backward",
                        kernel_costs.embedding_bag_backward(B, m, d, n_rows))
    return out


def embedding_bag_backward(grad: torch.Tensor, ids: torch.Tensor,
                           weights: torch.Tensor,
                           n_rows: int) -> torch.Tensor:
    """The table's gradient of the weighted bag sum on the card: grad
    (B, d) fp32 of the (B, d) output, ids (B, m) int32 (each in [0,
    n_rows), the caller's contract, unchecked) and weights (B, m) fp32,
    all CUDA tensors on one device, contiguous -> (n_rows, d) fp32, row
    r = sum over (b, j) with ids[b, j] = r of weights[b, j] * grad[b],
    added in ascending b * m + j with one rounding per multiply and per
    add (bit-identical to ``ref.embedding_bag_backward`` where that adds
    in position order, as ``index_add_`` does on the CPU); rows no id
    names are 0."""
    global launches
    for name, t, dtype in (("grad", grad, torch.float32),
                           ("ids", ids, torch.int32),
                           ("weights", weights, torch.float32)):
        if t.device.type != "cuda" or t.device != grad.device:
            raise ValueError(f"{name} on {t.device}: want grad's CUDA "
                             "device")
        if t.dtype != dtype or t.dim() != 2 or not t.is_contiguous():
            raise TypeError(f"{name}: {t.dtype} {tuple(t.shape)}, want "
                            f"contiguous 2-d {dtype}")
    (B, d), (Bi, m) = grad.shape, ids.shape
    if Bi != B or weights.shape != ids.shape:
        raise ValueError(f"grad {tuple(grad.shape)}, ids "
                         f"{tuple(ids.shape)}, weights "
                         f"{tuple(weights.shape)}")
    if n_rows < 1 or d < 1 or B * m >= 2 ** 31 or n_rows >= 2 ** 31:
        raise ValueError(f"n_rows={n_rows}, d={d}, B*m={B * m}: want "
                         "n_rows, d >= 1 and both below 2**31")
    keys, pos, out = _prepare(ids, n_rows, d)
    _build.launch("embedding_bag_bwd", grad.device, grad.data_ptr(),
                  keys.data_ptr(), pos.data_ptr(), weights.data_ptr(),
                  out.data_ptr(), B * m, m, d, n_rows,
                  torch.cuda.current_stream(grad.device).cuda_stream)
    launches += 1
    return out
