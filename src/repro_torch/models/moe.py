"""Mixture-of-experts FFN (port of ``repro/models/moe.py``, the paths
without a device mesh).

- ``moe_ffn_sort``: sort-based capacity dispatch. Tokens are split into
  capacity groups; in each, the (token, rank) slots are stably sorted by
  expert, each expert keeps its first ``C`` slots (the rest are dropped)
  and the batched per-expert SwiGLU runs over an (E, C, d) buffer a
  group. All groups run in one batched product (``torch.bmm`` over the
  expert axis).
- ``moe_ffn_einsum``: GShard one-hot dispatch, the decode path.

Router math is fp32. Experts are picked by the JAX tie rule: among equal
router probabilities the lowest expert index wins (a stable descending
sort; ``torch.topk`` does not promise that). A slot's position within
its expert follows the stable order of (token, rank), so the capacity
drops are the reference's. Dropped slots are masked, never scattered:
no write order of duplicate indices is relied on.

``moe_ffn_ep`` (expert parallelism over a mesh) is not ported.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models.layers import swiglu


def router_topk(x: torch.Tensor, w_router: torch.Tensor, top_k: int):
    """Softmax router. x (T, d), w_router (d, E). Returns (expert_idx
    (T, k) int32, weights (T, k) fp32, probs (T, E) fp32); ties go to the
    lowest expert index."""
    logits = x.to(torch.float32) @ w_router.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    weights, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, idx = weights[:, :top_k], idx[:, :top_k]
    weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)
    return idx.to(torch.int32), weights, probs


def load_balance_loss(probs: torch.Tensor, idx: torch.Tensor,
                      n_experts: int) -> torch.Tensor:
    """Switch-style auxiliary load-balancing loss. probs (..., T, E),
    idx (..., T, k) -> (...)."""
    me = probs.mean(dim=-2)
    ce = F.one_hot(idx[..., 0].long(), n_experts).to(torch.float32) \
        .mean(dim=-2)
    return n_experts * (me * ce).sum(-1)


def capacity(n_tokens: int, top_k: int, n_experts: int,
             factor: float) -> int:
    c = int(n_tokens * top_k * factor / n_experts)
    return max(8, -(-c // 8) * 8)  # round up to 8


def _experts(buf: torch.Tensor, params: dict) -> torch.Tensor:
    """Batched per-expert SwiGLU in the compute dtype. buf (E, R, d) ->
    (E, R, d)."""
    h = F.silu(torch.bmm(buf, params["wg"])) * torch.bmm(buf, params["wu"])
    return torch.bmm(h, params["wd"])


def _sort_dispatch(xg: torch.Tensor, params: dict, cfg: MoEConfig,
                   C: int):
    """Sort dispatch of G capacity groups at once. xg (G, Tg, d) ->
    (y (G, Tg, d), aux (G,), expert ids (G, Tg, k), kept (G, Tg, k))."""
    G, Tg, d = xg.shape
    E, k = cfg.n_experts, cfg.top_k
    N = Tg * k
    dev = xg.device
    idx, weights, probs = router_topk(xg.reshape(G * Tg, d),
                                      params["router"], k)
    aux = load_balance_loss(probs.reshape(G, Tg, E), idx.reshape(G, Tg, k),
                            E)

    flat_e = idx.reshape(G, N).long()              # expert of each slot
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = flat_e.gather(1, order)
    experts = torch.arange(E, device=dev).expand(G, E).contiguous()
    first = torch.searchsorted(sorted_e, experts, side="left")
    count = torch.searchsorted(sorted_e, experts, side="right") - first
    # position of each slot within its expert's run, in slot order
    # (order is a permutation: the scatter writes each index once)
    pos_sorted = torch.arange(N, device=dev) - first.gather(1, sorted_e)
    pos = torch.empty_like(pos_sorted).scatter_(1, order, pos_sorted)
    keep = pos < C

    # buffer row (e, c) holds the slot at sorted position first[e] + c
    # when e has more than c slots: a gather, zero where unfilled
    c_ar = torch.arange(C, device=dev)
    src = (first[:, :, None] + c_ar).clamp_max(N - 1).reshape(G, E * C)
    filled = (c_ar < count[:, :, None]).reshape(G * E * C, 1)
    rows = (order.gather(1, src) // k
            + torch.arange(G, device=dev)[:, None] * Tg).reshape(-1)
    buf = torch.where(filled, xg.reshape(G * Tg, d).index_select(0, rows),
                      0)
    buf = buf.reshape(G, E, C, d).transpose(0, 1).reshape(E, G * C, d)
    out = _experts(buf, params).reshape(E, G, C, d).transpose(0, 1) \
        .reshape(G * E * C, d)

    # each slot's output row, zero for a dropped slot
    slot_row = (torch.arange(G, device=dev)[:, None] * (E * C)
                + flat_e * C + pos.clamp_max(C - 1)).reshape(-1)
    y = torch.where(keep.reshape(-1, 1), out.index_select(0, slot_row), 0)
    # combine in the compute dtype, as the reference does
    y = torch.einsum("tkd,tk->td", y.reshape(G * Tg, k, d),
                     weights.to(xg.dtype))
    return (y.reshape(G, Tg, d), aux, idx.reshape(G, Tg, k),
            keep.reshape(G, Tg, k))


def _moe_ffn_sort_group(x: torch.Tensor, params: dict, cfg: MoEConfig,
                        C: int):
    """Sort-based dispatch MoE for ONE capacity group. x (T, d) ->
    ((T, d), aux). params: router (d, E); wg/wu (E, d, F); wd (E, F,
    d)."""
    y, aux, _, _ = _sort_dispatch(x[None], params, cfg, C)
    return y[0], aux[0]


def sort_groups(T: int, cfg: MoEConfig):
    """(groups, capacity a group) of ``moe_ffn_sort`` for T tokens:
    ``n_groups`` capped at T and halved until it divides T."""
    g = min(cfg.n_groups, T)
    while T % g:
        g //= 2
    return g, capacity(T // g, cfg.top_k, cfg.n_experts,
                       cfg.capacity_factor)


def _moe_ffn_sort(x: torch.Tensor, params: dict, cfg: MoEConfig):
    """``moe_ffn_sort`` that also returns the routing: (y (T, d), aux,
    expert ids (T, k), kept (T, k))."""
    T, d = x.shape
    g, C = sort_groups(T, cfg)
    y, aux, idx, keep = _sort_dispatch(x.reshape(g, T // g, d), params,
                                       cfg, C)
    y = y.reshape(T, d)
    if "shared_wg" in params:
        y = y + _shared_expert_dp(x, params)
    return y, aux.mean(), idx.reshape(T, -1), keep.reshape(T, -1)


def moe_ffn_sort(x: torch.Tensor, params: dict, cfg: MoEConfig):
    """Group-local sort dispatch. x (T, d) -> ((T, d), aux)."""
    y, aux, _, _ = _moe_ffn_sort(x, params, cfg)
    return y, aux


def _shared_expert_dp(x: torch.Tensor, params: dict) -> torch.Tensor:
    """Shared-expert SwiGLU (the reference's sharding constraints have
    nothing to pin on one device)."""
    return swiglu(x, params["shared_wg"], params["shared_wu"],
                  params["shared_wd"])


def _moe_ffn_einsum(x: torch.Tensor, params: dict, cfg: MoEConfig):
    """``moe_ffn_einsum`` that also returns the routing: (y (T, d), aux,
    expert ids (T, k), kept (T, k))."""
    T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    C = capacity(T, k, E, cfg.capacity_factor)
    idx, weights, probs = router_topk(x, params["router"], k)
    aux = load_balance_loss(probs, idx, E)

    onehot = F.one_hot(idx.long(), E).to(torch.float32)       # (T, k, E)
    flat_oh = onehot.reshape(T * k, E)
    flat_pos = torch.cumsum(flat_oh, dim=0) - flat_oh         # pos within e
    pos = (flat_pos * flat_oh).sum(-1).reshape(T, k)
    in_cap = pos < C
    pos_oh = (pos[..., None] == torch.arange(C, device=x.device)) \
        .to(torch.float32) * in_cap[..., None]
    dispatch = torch.einsum("tke,tkc->tec", onehot, pos_oh)   # (T, E, C)
    combine = torch.einsum("tec,tk,tke->tec", dispatch, weights, onehot)

    buf = torch.einsum("tec,td->ecd", dispatch.to(x.dtype), x)
    out = _experts(buf, params)
    y = torch.einsum("tec,ecd->td", combine.to(x.dtype), out)
    if "shared_wg" in params:
        y = y + _shared_expert_dp(x, params)
    return y, aux, idx, in_cap


def moe_ffn_einsum(x: torch.Tensor, params: dict, cfg: MoEConfig):
    """GShard one-hot einsum dispatch (the decode path). x (T, d) ->
    ((T, d), aux)."""
    y, aux, _, _ = _moe_ffn_einsum(x, params, cfg)
    return y, aux


def moe_ffn(x: torch.Tensor, params: dict, cfg: MoEConfig):
    if cfg.dispatch == "einsum":
        return moe_ffn_einsum(x, params, cfg)
    return moe_ffn_sort(x, params, cfg)
