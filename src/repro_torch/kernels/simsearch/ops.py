"""Public simsearch entry: the CUDA kernel for CUDA tensors, the plain
PyTorch version for CPU tensors, the kernel's meta branch
(``kernel.py``) for meta tensors."""
from __future__ import annotations

import torch

from repro_torch.kernels.simsearch import kernel as _kernel
from repro_torch.kernels.simsearch.ref import simsearch_ref


def cosine_topk(queries: torch.Tensor, corpus: torch.Tensor, k: int = 1):
    """Cosine top-k, (B, d) x (N, d) -> ((B, k) fp32, (B, k) int32),
    ties to the lowest index. A CPU tensor takes the plain version; a
    CUDA tensor goes through the kernel, which raises rather than fall
    back. A meta tensor allocates the kernel's outputs and reports its
    cost to an active ``ProgramCounter``."""
    if queries.device.type == "meta":
        return _kernel.simsearch_meta(queries, corpus, k)
    if queries.device.type != "cuda":
        return simsearch_ref(queries, corpus, k)
    return _kernel.simsearch(queries.to(torch.float32).contiguous(),
                             corpus.to(torch.float32).contiguous(), k)
