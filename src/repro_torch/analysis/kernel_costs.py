"""FLOPs and bytes of each hand-written kernel.

One rule for every kernel (the rule of ``PERF.md`` section 6): the
bytes a call must move are each input read once and each output
written once, whatever the kernel reads again; its operations are the
multiply-adds the function needs (2 a product term), counted in the
type that bounds it. Flash attention counts its causal work, S (S + 1)
/ 2 (query, key) pairs a head, not S x S. Where the work depends on the
data, a formula takes the count as an argument (the live cache
positions, the distinct probed bands, the distinct table rows): a card
run passes what its inputs need; a meta branch, which cannot read the
data, passes the most the shapes allow, and says so.

Each kernel's meta branch sits beside its launch
(``kernels/<name>/kernel.py``, ``*_meta``): it allocates the outputs
and workspace the launch allocates, by the same helper, and reports
its call's cost from these formulas by :func:`record`.
"""
from __future__ import annotations

from typing import NamedTuple

from repro_torch.analysis.counter import record_kernel
from repro_torch.analysis.roofline import bound


class Cost(NamedTuple):
    flops: float
    bytes: float
    dtype: str          # the type whose peak bounds the operations

    def bound(self):
        """(bound_ms, bound_by) on the H100 (``roofline.bound``)."""
        return bound(self.bytes, self.flops, self.dtype)


def _dtype(itemsize: int) -> str:
    return "bfloat16" if itemsize == 2 else "float32"


# ---------------------------------------------------------------------
# formulas
# ---------------------------------------------------------------------

def simsearch(B: int, N: int, d: int, k: int = 1) -> Cost:
    """Cosine top-k of (B, d) fp32 queries over an (N, d) fp32 corpus:
    both read once, (B, k) scores and int32 ids written; 2 B N d in
    TF32, the kernel's screen on the tensor cores. The exact fp32
    rescore of the screened candidates depends on the data and is left
    out, so the bound stays a lower one."""
    return Cost(2.0 * B * N * d, (N * d + B * d) * 4.0 + B * k * 8.0,
                "tfloat32")


def flash_attention(B: int, S: int, H: int, Kv: int, D: int,
                    itemsize: int = 2, lse: bool = False) -> Cost:
    """Causal GQA prefill: q and the output (B, S, H, D), k and v (B,
    S, Kv, D) moved once, and with ``lse`` the (B, H, S) fp32
    log-sum-exp written; QK^T and PV over the S (S + 1) / 2 causal
    pairs of each head, 4 D operations a pair."""
    pairs = S * (S + 1) // 2
    return Cost(4.0 * B * H * D * pairs,
                itemsize * (2.0 * B * S * H * D + 2.0 * B * S * Kv * D)
                + (4.0 * B * H * S if lse else 0.0), _dtype(itemsize))


def flash_attention_bwd(B: int, S: int, H: int, Kv: int, D: int,
                        itemsize: int = 2) -> Cost:
    """Causal GQA attention's backward: q, o and dO (B, S, H, D), k and
    v (B, S, Kv, D) and the (B, H, S) fp32 log-sum-exp read, dq, dk and
    dv written; 5 products over the causal pairs (P recomputed, dV, dP,
    dQ, dK), 10 D operations a pair."""
    pairs = S * (S + 1) // 2
    return Cost(10.0 * B * H * D * pairs,
                itemsize * (4.0 * B * S * H * D + 4.0 * B * S * Kv * D)
                + 4.0 * B * H * S, _dtype(itemsize))


def flash_attention_fwd_bwd(B: int, S: int, H: int, Kv: int, D: int,
                            itemsize: int = 2) -> Cost:
    """Forward (with its log-sum-exp) and backward of causal attention:
    the sum of the two calls' costs."""
    fwd = flash_attention(B, S, H, Kv, D, itemsize, lse=True)
    bwd = flash_attention_bwd(B, S, H, Kv, D, itemsize)
    return Cost(fwd.flops + bwd.flops, fwd.bytes + bwd.bytes, fwd.dtype)


def decode_attention(B: int, H: int, Kv: int, D: int, live: int,
                     itemsize: int = 2) -> Cost:
    """One-token GQA decode over ``live`` cache positions in all (the
    sum of the lengths): q and the output, each live k and v row, the
    int32 lengths; 4 D operations a (head, live position)."""
    return Cost(4.0 * live * H * D,
                itemsize * (2.0 * B * H * D + 2.0 * live * Kv * D)
                + 4.0 * B, _dtype(itemsize))


def ivf_scan(B: int, nprobe: int, cap: int, d: int, C: int,
             n_bands: int) -> Cost:
    """Int8 band scan: the ``n_bands`` distinct probed clusters' bands
    (codes, a scale and an id a slot) read once, the queries and
    cluster ids, (B, C) candidates written; 2 d a scored slot."""
    return Cost(2.0 * B * nprobe * cap * d,
                n_bands * cap * (d + 8.0) + B * d * 4.0 + B * nprobe * 4.0
                + B * C * 8.0, "float32")


def fused_serve(B: int, nprobe: int, cap: int, d: int, C: int, Cd: int,
                n_bands: int, rows: int) -> Cost:
    """``ivf_scan`` plus the ``rows`` bf16 dynamic-tier rows with their
    int32 ids, and (B, Cd) more candidates written."""
    return Cost(2.0 * B * (nprobe * cap + rows) * d,
                n_bands * cap * (d + 8.0) + rows * (2.0 * d + 4.0)
                + B * d * 4.0 + B * nprobe * 4.0 + B * (C + Cd) * 8.0,
                "float32")


def embedding_bag(B: int, m: int, d: int, rows: int,
                  itemsize: int = 4) -> Cost:
    """Weighted bag sum: the ``rows`` distinct table rows the ids name,
    int32 ids and fp32 weights (B, m), the (B, d) fp32 output; 2 d a
    (bag, id)."""
    return Cost(2.0 * B * m * d,
                rows * d * itemsize + B * m * 8.0 + B * d * 4.0, "float32")


def embedding_bag_backward(B: int, m: int, d: int, V: int) -> Cost:
    """The table's gradient: the (B, d) fp32 output gradient, ids and
    weights read, the whole (V, d) fp32 gradient written; 2 d a
    (bag, id)."""
    return Cost(2.0 * B * m * d, B * d * 4.0 + B * m * 8.0 + V * d * 4.0,
                "float32")


def record(name: str, cost: Cost) -> None:
    """Report one call of kernel ``name`` to every active
    ``counter.ProgramCounter`` (a meta branch's last step)."""
    record_kernel(name, cost.flops, cost.bytes, cost.dtype)
