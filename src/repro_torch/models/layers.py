"""Shared transformer building blocks: RMSNorm, RoPE, SwiGLU, init
helpers (port of ``repro/models/layers.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in fp32, cast back to the input dtype."""
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * weight.to(torch.float32)).to(x.dtype)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin tables for rotary embeddings: positions of any shape P ->
    (P..., head_dim/2) fp32."""
    half = head_dim // 2
    exponent = torch.arange(half, dtype=torch.float32,
                            device=positions.device) / half
    freqs = 1.0 / (theta ** exponent)
    angles = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE. x (..., n_heads, head_dim); cos/sin broadcastable
    to (..., head_dim/2) over the position axes."""
    x32 = x.to(torch.float32)
    x1, x2 = torch.chunk(x32, 2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s],
                     dim=-1).to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU FFN: (silu(x @ Wg) * (x @ Wu)) @ Wd, in the compute dtype."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def dense_init(shape, dtype, generator: torch.Generator, device,
               scale: float | None = None) -> torch.Tensor:
    """Truncated-normal (+-3 sigma) fan-in init, drawn in fp32 (the
    distribution of the JAX ``dense_init``). A stacked tensor (3-D or
    more) is drawn one leading slab at a time, so the fp32 temporary is
    one layer's, not the whole stack's."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    if scale is None:
        scale = fan_in ** -0.5
    if len(shape) < 3:
        w = torch.empty(shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0,
                                    generator=generator)
        return (w * scale).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=device)
    for slab in out:
        slab.copy_(dense_init(slab.shape, torch.float32, generator, device,
                              scale))
    return out


def embed_init(shape, dtype, generator: torch.Generator,
               device) -> torch.Tensor:
    return dense_init(shape, dtype, generator, device, scale=1.0)
