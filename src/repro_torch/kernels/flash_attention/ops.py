"""Public causal-attention entry: the CUDA kernel for CUDA tensors, the
plain PyTorch version for CPU tensors."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel as _kernel
from repro_torch.models.attention import causal_attention


def attention(q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    """Causal GQA attention. q (B,S,H,D); k,v (B,S,K,D) -> (B,S,H,D) in
    q.dtype. A CPU tensor takes the plain version; a CUDA tensor goes
    through the kernel, which raises rather than fall back."""
    if q.device.type != "cuda":
        return causal_attention(q, k, v)
    return _kernel.flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous())
