"""Wrapper of the hand-written CUDA flash-attention kernel
(``csrc/flash_attention.cu``), which replaces the TPU kernel
``repro/kernels/flash_attention/kernel.py:flash_attention``. The source
note there says what bounds it on an H100 and how its design answers
that."""
from __future__ import annotations

import torch

from repro_torch.analysis import kernel_costs
from repro_torch.kernels import _build

HEAD_DIMS = (64, 128)
MAX_GROUP = 64          # bf16: a block's 64 rows hold >= 1 position x G
launches = 0            # kernel launches, counted by the wrapper


def flash_attention_meta(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor, return_lse: bool = False):
    """The kernel's meta branch: its output (and log-sum-exp) on the
    meta device (the kernel allocates nothing else), and its cost
    (``kernel_costs.flash_attention``, the causal work) reported to an
    active ``ProgramCounter``. The plain version never runs: at
    ``prefill_32k`` it would reckon a 64 GiB score matrix that the
    kernel never builds."""
    B, S, H, D = q.shape
    out, lse = _outputs(q, return_lse)
    if B and S:
        kernel_costs.record("flash_attention", kernel_costs.flash_attention(
            B, S, H, k.shape[2], D, q.element_size(), lse=return_lse))
    return (out, lse) if return_lse else out


def _outputs(q: torch.Tensor, return_lse: bool):
    """The output, and the (B, H, S) fp32 log-sum-exp when asked."""
    B, S, H, _ = q.shape
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device) \
        if return_lse else None
    return torch.empty_like(q), lse


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 **same_as_q) -> None:
    """Raise unless q (B, S, H, D) and k, v (B, S, K, D) are contiguous
    CUDA tensors of one device and one dtype (bf16 or fp32), H % K == 0,
    D in HEAD_DIMS and, in bf16, G = H / K at most MAX_GROUP; each
    tensor of ``same_as_q`` (name -> tensor) as q in all of that and in
    shape."""
    for name, t in (("q", q), ("k", k), ("v", v), *same_as_q.items()):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} on {t.device}: want q's CUDA device")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash kernel takes bf16 or fp32, got {q.dtype}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 \
            or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3] \
            or any(t.shape != q.shape for t in same_as_q.values()):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}" + "".join(
                             f", {n} {tuple(t.shape)}"
                             for n, t in same_as_q.items()))
    B, S, H, D = q.shape
    K = k.shape[2]
    if H % K or D not in HEAD_DIMS:
        raise ValueError(f"H={H}, K={K}, D={D}: want H % K == 0 and D in "
                         f"{HEAD_DIMS}")
    if q.dtype == torch.bfloat16 and H // K > MAX_GROUP:
        raise ValueError(f"G = H/K = {H // K}: the bf16 kernel carries at "
                         f"most {MAX_GROUP} heads of a group in a block")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    pair_tiles: bool | None = None,
                    return_lse: bool = False):
    """Causal GQA prefill attention on the card. q (B, S, H, D); k, v
    (B, S, K, D); contiguous CUDA tensors of one dtype (bf16 on the
    tensor cores, or fp32). Returns (B, S, H, D) in q.dtype; with
    ``return_lse`` also each row's natural log-sum-exp of its scaled,
    causally masked scores, (B, H, S) fp32, written by the same launch
    (the backward kernel's input). Any S is taken. ``pair_tiles``
    (bf16): one block takes a long and a short q tile of the causal
    triangle (True) or one q tile (False); None pairs when the unpaired
    grid has more blocks than the card has SMs."""
    global launches
    check_inputs(q, k, v)
    B, S, H, D = q.shape
    out, lse = _outputs(q, return_lse)
    if B == 0 or S == 0:
        return (out, lse) if return_lse else out
    _build.launch("flash_attention_fwd", q.device, q.data_ptr(),
                  k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  lse.data_ptr() if return_lse else None, B, S, H,
                  k.shape[2], D,
                  -1 if pair_tiles is None else int(pair_tiles), D ** -0.5,
                  int(q.dtype == torch.bfloat16),
                  torch.cuda.current_stream(q.device).cuda_stream)
    launches += 1
    return (out, lse) if return_lse else out
