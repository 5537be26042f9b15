"""Microbatched gradient accumulation (the ``accumulate_microbatches``
part of ``repro/distributed/overlap.py``).

The reference accumulates in a ``lax.scan`` so that, on a TPU mesh, one
microbatch's backward overlaps the previous one's gradient reduction.
On one card there is no reduction to overlap: the port runs the
microbatches one after another, which bounds the activations held to
one microbatch's. ``bucket_leaves`` waits with the rest of the
XLA-specific tooling (ROADMAP.md queue 4, "XLA-specific tooling").
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.training.optimizer import value_and_grad
from repro_torch.tree import leaves, tree_map


def accumulate_microbatches(loss_fn: Callable, n_micro: int) -> Callable:
    """loss_fn(params, batch) -> scalar  ==>  grad_fn(params, batch) ->
    (loss, grads), the batch split into ``n_micro`` microbatches along
    axis 0 (which ``n_micro`` must divide); the microbatches' losses and
    gradients are summed in fp32 from zero, then scaled by
    ``1 / n_micro``, as the reference does."""
    gfn = value_and_grad(loss_fn)

    def grad_fn(params, batch):
        B = next(iter(batch.values())).shape[0]
        if B % n_micro:
            raise ValueError(f"batch of {B} rows into {n_micro} "
                             "microbatches")
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)
        loss_acc = torch.zeros((), dtype=torch.float32,
                               device=leaves(params)[0].device)
        for i in range(n_micro):
            mb = {k: v.reshape((n_micro, B // n_micro) + v.shape[1:])[i]
                  for k, v in batch.items()}
            loss, g = gfn(params, mb)
            acc = tree_map(torch.add, acc, g)
            loss_acc = loss_acc + loss
        scale = 1.0 / n_micro
        return loss_acc * scale, tree_map(lambda x: x * scale, acc)
    return grad_fn
