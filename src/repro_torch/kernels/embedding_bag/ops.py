"""Public embedding-bag entry: the CUDA kernel for CUDA tensors, the
plain PyTorch version for CPU tensors."""
from __future__ import annotations

import torch

from repro_torch.kernels.embedding_bag import kernel as _kernel
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  weights: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """table (V, d); ids (B, m), each in [0, V); weights (B, m) -> (B, d)
    fp32 = sum_j weights[b, j] * table[ids[b, j]]. ``groups`` dividing B
    marks bag ``b * groups + g`` as group g, which only the kernel's
    schedule reads. A CPU tensor takes the plain version; a CUDA tensor
    goes through the kernel, which raises rather than fall back. B = 0
    gives an empty (0, d) fp32 tensor and launches nothing."""
    if table.device.type != "cuda":
        return embedding_bag_ref(table, ids, weights)
    return _kernel.embedding_bag(table.contiguous(),
                                 ids.to(torch.int32).contiguous(),
                                 weights.to(torch.float32).contiguous(),
                                 groups)
