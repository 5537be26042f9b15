"""Wrapper of the hand-written CUDA attention backward
(``flash_attention_bwd`` in ``csrc/flash_attention_bwd.cu``).

It replaces no TPU kernel: the JAX package differentiates its jnp
attention (``repro/models/attention.py:39``). The source note says what
bounds it on an H100 and how its design answers that: a pass for
delta = rowsum(dO * O), then a dK/dV kernel and a dQ kernel that each
recompute P from the forward's log-sum-exp and write every gradient
element once, with no atomics, so the result is the same bits every
run. In bf16 both are warp-specialised wgmma kernels: a producer warp
loads 128-byte swizzled tiles by TMA into a ring of shared memory, and
two consumer warpgroups run the products with fp32 accumulators in
registers. TMA takes only 16-byte aligned bases (and the delta pass
loads 16 bytes a lane), so a bf16 q, k, v, o or dout view that starts
elsewhere is refused here.
"""
from __future__ import annotations

import torch

from repro_torch.analysis import kernel_costs
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.kernel import check_inputs

launches = 0            # wrapper calls that launched the kernels


def _outputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """dq, dk, dv in the inputs' dtype, and the (B, H, S) fp32 delta
    workspace."""
    B, S, H, _ = q.shape
    return (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v),
            torch.empty((B, H, S), dtype=torch.float32, device=q.device))


def flash_attention_bwd_meta(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor):
    """The kernels' meta branch: dq, dk, dv and the delta workspace on
    the meta device, as the launch allocates them, and the cost
    (``kernel_costs.flash_attention_bwd``) reported to an active
    ``ProgramCounter``. No (S, S) tensor is made."""
    B, S, H, D = q.shape
    dq, dk, dv, _ = _outputs(q, k, v)
    if B and S:
        kernel_costs.record("flash_attention_bwd",
                            kernel_costs.flash_attention_bwd(
                                B, S, H, k.shape[2], D, q.element_size()))
    return dq, dk, dv


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor):
    """The gradients of causal GQA attention on the card. q, o and dout
    (B, S, H, D), k and v (B, S, K, D): contiguous CUDA tensors of one
    device and dtype (bf16 on the tensor cores, or fp32), o the forward
    kernel's output on q, k, v and lse its ``return_lse`` (B, H, S)
    fp32; in bf16, q, k, v, o and dout start on 16 bytes. Returns (dq,
    dk, dv) in the inputs' dtype, accumulated in fp32 in a fixed order:
    two calls on the same inputs give the same bits."""
    global launches
    check_inputs(q, k, v, o=o, dout=dout)
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v), ("o", o),
                        ("dout", dout)):
            if t.data_ptr() % 16:
                raise ValueError(f"{name} starts at {t.data_ptr():#x}: the "
                                 f"bf16 kernels' TMA and 16-byte loads want "
                                 f"a 16-byte aligned base")
    B, S, H, D = q.shape
    if lse.device != q.device or lse.dtype != torch.float32 \
            or lse.shape != (B, H, S) or not lse.is_contiguous():
        raise ValueError(f"lse {lse.dtype} {tuple(lse.shape)} on "
                         f"{lse.device}: want contiguous fp32 "
                         f"{(B, H, S)} on {q.device}")
    dq, dk, dv, delta = _outputs(q, k, v)
    if B == 0 or S == 0:
        return dq, dk, dv
    _build.launch("flash_attention_bwd", q.device, q.data_ptr(),
                  k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                  dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                  dv.data_ptr(), delta.data_ptr(), B, S, H, k.shape[2], D,
                  D ** -0.5, int(q.dtype == torch.bfloat16),
                  torch.cuda.current_stream(q.device).cuda_stream)
    launches += 1
    return dq, dk, dv
