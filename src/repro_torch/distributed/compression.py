"""Gradient compression for a slow cross-node all-reduce (port of
``repro/distributed/compression.py``).

int8 block quantization with error feedback (EF-SGD style): quantize
(grad + residual), send the int8 payload (4x fewer bytes than fp32),
keep the quantization error as the local residual for the next step.
Plain tensor ops on the input's device, in the reference's arithmetic:
a block's scale is its max |x| over 127 (a true fp32 division), floored
at 1e-12; each value is x / scale rounded half to even (``torch.round``,
as ``jnp.round``), clipped to [-127, 127] and cast to int8. On the same
input the card and the CPU give the same bits.

A value comes back within ``scale / 2 + 2^-24 (|x| + |q| scale)``,
about one fp32 spacing of |x| past half a step: the rounding of
``x / scale`` moves it by at most half a step, and the division and the
product ``q * scale`` each round once.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.tree import leaves, tree_map, unflatten

BLOCK = 256


def _pad_to_block(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    n = x.numel()
    flat = x.reshape(-1)
    pad = (-n) % BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat, n


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """x (any shape) -> (int8 values (nb, BLOCK), fp32 scales (nb,), n)."""
    flat, n = _pad_to_block(x.to(torch.float32))
    blocks = flat.reshape(-1, BLOCK)
    # a tensor divisor: CUDA turns division by a Python scalar into a
    # product with its rounded reciprocal
    scale = torch.amax(blocks.abs(), dim=1) \
        / torch.full((), 127.0, dtype=torch.float32, device=blocks.device)
    scale = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(blocks / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale, n


def dequantize(q: torch.Tensor, scale: torch.Tensor, n: int,
               shape) -> torch.Tensor:
    x = (q.to(torch.float32) * scale[:, None]).reshape(-1)[:n]
    return x.reshape(shape)


def compress_grads_with_feedback(grads: Any, residual: Any):
    """Returns (quantized_tree, new_residual). quantized_tree leaves are
    (q, scale, n) tuples ready for the all-reduce; residual carries the
    per-leaf quantization error (error feedback)."""
    def one(g, r):
        x = g.to(torch.float32) + r
        q, s, n = quantize(x)
        return (q, s, n), x - dequantize(q, s, n, g.shape)
    pairs = [one(g, r) for g, r in zip(leaves(grads), leaves(residual))]
    return (unflatten(grads, [p[0] for p in pairs]),
            unflatten(grads, [p[1] for p in pairs]))


def init_residual(grads_like: Any) -> Any:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads_like)


def roundtrip(x: torch.Tensor) -> torch.Tensor:
    """quantize -> dequantize (for tests / simulating the payload)."""
    q, s, n = quantize(x)
    return dequantize(q, s, n, x.shape)
