"""Public causal-attention entry: the CUDA kernels for CUDA tensors (under
autograd, inside :class:`FlashAttention`, the forward kernel and the
backward kernel), the plain PyTorch version for CPU tensors; meta
tensors take the CUDA route with the kernels' meta branches
(``kernel.py``, ``backward.py``) in place of the kernels."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import backward as _backward
from repro_torch.kernels.flash_attention import kernel as _kernel
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_lse_ref)
from repro_torch.models.attention import causal_attention


class FlashAttention(torch.autograd.Function):
    """The CUDA flash kernels under autograd. Forward: the kernel
    (``csrc/flash_attention.cu``) with its log-sum-exp; q, k, v, the
    output and the log-sum-exp are saved. Backward: the backward kernel
    (``csrc/flash_attention_bwd.cu``), which raises rather than fall
    back; the reference differentiates its jnp attention, and there is
    no TPU backward kernel to port. No (S, S) tensor is made in either
    pass. On meta tensors both take their meta branches. A CPU tensor
    reaches the Function only where the plain attention stands in for
    the forward kernel (``kernel.flash_attention`` replaced, in tests):
    its log-sum-exp and its backward are then the plain versions'."""

    @staticmethod
    def forward(ctx, q, k, v):
        if q.device.type in ("cuda", "meta"):
            out, lse = _flash(q, k, v, return_lse=True)
        else:
            out, lse = _kernel.flash_attention(q, k, v), \
                flash_attention_lse_ref(q, k)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, grad):
        q, k, v, out, lse = ctx.saved_tensors
        grad = grad.contiguous()
        if q.device.type == "meta":
            return _backward.flash_attention_bwd_meta(q, k, v)
        if q.device.type == "cuda":
            return _backward.flash_attention_bwd(q, k, v, out, lse, grad)
        return tuple(g.to(t.dtype) for g, t in zip(
            flash_attention_bwd_ref(q, k, v, out, lse, grad), (q, k, v)))


def _flash(q, k, v, return_lse: bool = False):
    """The kernel, or on meta tensors its meta branch (outputs empty,
    the cost reported; the plain version never runs)."""
    if q.device.type == "meta":
        return _kernel.flash_attention_meta(q, k, v, return_lse=return_lse)
    return _kernel.flash_attention(q, k, v, return_lse=return_lse)


def attention(q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    """Causal GQA attention. q (B,S,H,D); k,v (B,S,K,D) -> (B,S,H,D) in
    q.dtype. A CPU tensor takes the plain version (autograd
    differentiates it directly); a CUDA tensor goes through the kernels,
    which raise rather than fall back: under :class:`FlashAttention`
    (the forward and backward kernels) when grad is enabled and any of
    q, k, v needs a gradient, the forward kernel directly otherwise
    (serving). A meta tensor takes the CUDA route, the kernels' meta
    branches in place of the kernels."""
    if q.device.type not in ("cuda", "meta"):
        return causal_attention(q, k, v)
    args = (q.contiguous(), k.contiguous(), v.contiguous())
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return FlashAttention.apply(*args)
    return _flash(*args)
