"""Public causal-attention entry: the CUDA kernel for CUDA tensors (under
autograd, inside :class:`FlashAttention`), the plain PyTorch version for
CPU tensors."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel as _kernel
from repro_torch.models.attention import causal_attention


class FlashAttention(torch.autograd.Function):
    """The CUDA flash kernel under autograd. Forward: the kernel
    (``csrc/flash_attention.cu``); q, k and v are saved, the output and
    its softmax statistics are not. Backward: the plain
    :func:`models.attention.causal_attention` recomputed on the saved
    inputs under ``enable_grad`` and differentiated (the reference
    differentiates its jnp attention; there is no TPU backward kernel to
    port). The (S, S) scores of that recompute live only inside the
    backward call."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _kernel.flash_attention(q, k, v)

    @staticmethod
    def backward(ctx, grad):
        with torch.enable_grad():
            q, k, v = (t.detach().requires_grad_(True)
                       for t in ctx.saved_tensors)
            out = causal_attention(q, k, v)
            return torch.autograd.grad(out, (q, k, v), grad)


def attention(q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    """Causal GQA attention. q (B,S,H,D); k,v (B,S,K,D) -> (B,S,H,D) in
    q.dtype. A CPU tensor takes the plain version (autograd
    differentiates it directly); a CUDA tensor goes through the kernel,
    which raises rather than fall back: under :class:`FlashAttention`
    when grad is enabled and any of q, k, v needs a gradient, directly
    otherwise (serving)."""
    if q.device.type != "cuda":
        return causal_attention(q, k, v)
    args = (q.contiguous(), k.contiguous(), v.contiguous())
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return FlashAttention.apply(*args)
    return _kernel.flash_attention(*args)
