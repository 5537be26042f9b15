"""Public embedding-bag entry: the CUDA kernels for CUDA tensors, the
plain PyTorch version for CPU tensors, both differentiable in the
table; on ``meta`` tensors the kernels' meta branches
(``kernel.py``), which allocate the kernels' outputs and
report their costs to an active ``ProgramCounter``."""
from __future__ import annotations

import torch

from repro_torch.kernels.embedding_bag import backward as _backward
from repro_torch.kernels.embedding_bag import kernel as _kernel
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref


class EmbeddingBag(torch.autograd.Function):
    """The CUDA bag under autograd. Forward: the kernel
    (``embedding_bag_fwd`` in ``csrc/embedding_bag.cu``). Backward: the
    table's gradient by the backward kernel (``embedding_bag_bwd``,
    :func:`backward.embedding_bag_backward`): each row of ``weights[b,
    j] * grad[b]`` summed over ``ids[b, j] = r`` in ascending b * m + j
    and written once, no atomics, so two runs give the same bits; cast
    to the table's dtype. It raises rather than fall back. ``ids`` and
    ``weights`` get no gradient. On meta tensors both halves take their
    kernels' meta branches."""

    @staticmethod
    def forward(ctx, table, ids, weights, groups):
        ctx.save_for_backward(ids, weights)
        ctx.n_rows, ctx.dtype = table.shape[0], table.dtype
        if table.device.type == "meta":
            return _kernel.embedding_bag_meta(table, ids, weights)
        return _kernel.embedding_bag(table, ids, weights, groups)

    @staticmethod
    def backward(ctx, grad):
        ids, weights = ctx.saved_tensors
        grad = grad.to(torch.float32).contiguous()
        if grad.device.type == "meta":
            g = _backward.embedding_bag_backward_meta(grad, ids,
                                                      ctx.n_rows)
        else:
            g = _backward.embedding_bag_backward(grad, ids, weights,
                                                 ctx.n_rows)
        return g.to(ctx.dtype), None, None, None


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  weights: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """table (V, d); ids (B, m), each in [0, V); weights (B, m) -> (B, d)
    fp32 = sum_j weights[b, j] * table[ids[b, j]]. ``groups`` dividing B
    marks bag ``b * groups + g`` as group g, which only the kernel's
    schedule reads. A CPU tensor takes the plain version (autograd
    differentiates it directly); a CUDA tensor goes through the kernel,
    which raises rather than fall back, under :class:`EmbeddingBag` when
    the table needs a gradient. ``weights`` must not need one: the
    models derive them from a mask. B = 0 gives an empty (0, d) fp32
    tensor and launches nothing. A meta tensor takes the same route
    with the kernels' meta branches in place of the kernels."""
    if weights.requires_grad:
        raise ValueError("weights require grad: the bag differentiates "
                         "the table only")
    if table.device.type not in ("cuda", "meta"):
        return embedding_bag_ref(table, ids, weights)
    args = (table.contiguous(), ids.to(torch.int32).contiguous(),
            weights.to(torch.float32).contiguous(), groups)
    if table.requires_grad and torch.is_grad_enabled():
        return EmbeddingBag.apply(*args)
    # serving: the Function's host cost is a large share of a small
    # call's (serve_p99 on an H100: 0.0616 against 0.0428 ms as
    # launched, PERF.md section 6)
    if table.device.type == "meta":
        return _kernel.embedding_bag_meta(*args[:3])
    return _kernel.embedding_bag(*args)
