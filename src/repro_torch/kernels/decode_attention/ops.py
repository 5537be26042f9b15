"""Public decode-attention entry: the CUDA kernel for CUDA tensors, the
plain PyTorch version for CPU tensors, the kernel's meta branch
(``kernel.py``) for meta tensors."""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention import kernel as _kernel
from repro_torch.models import attention as attn_lib


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor,
                     return_lse: bool = False):
    """q (B, H, D); caches (B, S, K, D); lengths (B,) -> (B, H, D) in
    q.dtype, and with ``return_lse`` each head's log-sum-exp (B, H)
    fp32. A CPU tensor takes the plain version; a CUDA tensor goes
    through the kernel, which raises rather than fall back. A meta
    tensor allocates the kernel's outputs and reports its cost to an
    active ``ProgramCounter``."""
    if q.device.type == "meta":
        return _kernel.decode_attention_meta(q, k_cache, v_cache, lengths,
                                             return_lse)
    if q.device.type != "cuda":
        if return_lse:
            return attn_lib.decode_attention_lse(q, k_cache, v_cache,
                                                 lengths)
        return attn_lib.decode_attention(q[:, None], k_cache, v_cache,
                                         lengths)[:, 0]
    return _kernel.decode_attention(q.contiguous(), k_cache.contiguous(),
                                    v_cache.contiguous(),
                                    lengths.to(torch.int32).contiguous(),
                                    return_lse)
