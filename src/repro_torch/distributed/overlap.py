"""Microbatched gradient accumulation and bucketed reductions (port of
``repro/distributed/overlap.py``).

The reference accumulates in a ``lax.scan`` so that, on a TPU mesh, one
microbatch's backward overlaps the previous one's gradient reduction.
On one card there is no reduction to overlap: the port runs the
microbatches one after another, which bounds the activations held to
one microbatch's. ``bucket_leaves`` concatenates many small gradient
leaves into a few fp32 vectors, so that a reduction sends few large
transfers.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.training.optimizer import value_and_grad
from repro_torch.tree import leaves, tree_map, unflatten


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


def bucket_leaves(tree: Any, bucket_bytes: int = 4 * 2**20):
    """Group the leaves of ``tree``, in the reference's leaf order, into
    buckets: a bucket closes once its leaves' sizes times 4 bytes reach
    ``bucket_bytes``, whatever their dtype. Returns (vecs, unbucket):
    one fp32 vector a bucket, the bucket's leaves flattened and
    concatenated on their device, and ``unbucket(new_vecs)``, a tree of
    ``tree``'s structure whose leaves are cut back out of ``new_vecs``
    with their shapes and dtypes (exact for bf16 and fp32 leaves)."""
    flat = leaves(tree)
    sizes = [int(x.numel()) for x in flat]
    buckets, cur, cur_bytes = [], [], 0
    for i in range(len(flat)):
        cur.append(i)
        cur_bytes += sizes[i] * 4
        if cur_bytes >= bucket_bytes:
            buckets.append(cur)
            cur, cur_bytes = [], 0
    if cur:
        buckets.append(cur)

    vecs = [torch.cat([flat[i].to(torch.float32).reshape(-1) for i in b])
            for b in buckets]

    def unbucket(new_vecs):
        out = list(flat)
        for b, v in zip(buckets, new_vecs):
            off = 0
            for i in b:
                out[i] = v[off:off + sizes[i]].reshape(flat[i].shape) \
                    .to(flat[i].dtype)
                off += sizes[i]
        return unflatten(tree, out)
    return vecs, unbucket
