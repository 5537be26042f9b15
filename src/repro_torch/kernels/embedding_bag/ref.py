"""Plain PyTorch version of the embedding-bag kernel."""
from __future__ import annotations

import torch


def embedding_bag_ref(table: torch.Tensor, ids: torch.Tensor,
                      weights: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """Weighted bag reduce: table (V, d), ids (B, m), weights (B, m).
    ``groups`` is the kernel's schedule (the order it takes the bags
    in), taken here so the two share one signature; the sum does not
    depend on it.

    Returns (B, d) fp32 = sum_j weights[b, j] * table[ids[b, j]] (mean
    mode = weights 1/count; masked entries = weight 0). The sum runs
    over j in order from zero, one fp32 multiply and one fp32 add a
    step, as the TPU kernel accumulates (``kernel.py:22-31``); the CUDA
    kernel rounds the same way, so on the card the two agree bit for
    bit."""
    B, m = ids.shape
    w = weights.to(torch.float32)
    acc = torch.zeros((B, table.shape[1]), dtype=torch.float32,
                      device=table.device)
    for j in range(m):
        acc = acc + w[:, j, None] * table[ids[:, j].long()].to(torch.float32)
    return acc


def embedding_bag_backward(grad: torch.Tensor, ids: torch.Tensor,
                           weights: torch.Tensor,
                           n_rows: int) -> torch.Tensor:
    """The table's gradient of the weighted bag sum: grad (B, d) of the
    (B, d) output, ids and weights (B, m) -> (n_rows, d) fp32, row r
    holding sum over (b, j) with ids[b, j] = r of weights[b, j] *
    grad[b]. One ``index_add_`` scatter: on the CPU it adds a row's
    terms in ascending flat position b * m + j, one rounding a multiply
    and an add, the order of the backward kernel
    (``backward.embedding_bag_backward``), so the two agree bit for bit;
    on the card its atomics would add in an order that changes from run
    to run. The JAX package has no kernel here: it differentiates its
    jnp bag (``repro/models/recsys.py:42-51``, ``:59``)."""
    d = grad.shape[1]
    contrib = weights.to(torch.float32)[:, :, None] \
        * grad.to(torch.float32)[:, None, :]
    out = torch.zeros((n_rows, d), dtype=torch.float32, device=grad.device)
    return out.index_add_(0, ids.reshape(-1).long(), contrib.reshape(-1, d))
