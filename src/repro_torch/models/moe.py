"""Mixture-of-experts FFN (port of ``repro/models/moe.py``, the paths
without a device mesh).

- ``moe_ffn_sort``: sort-based capacity dispatch. Tokens are split into
  capacity groups; in each, the (token, rank) slots are stably sorted by
  expert, each expert keeps its first ``C`` slots (the rest are dropped)
  and the batched per-expert SwiGLU runs over an (E, C, d) buffer a
  group. All groups run in one batched product (``torch.bmm`` over the
  expert axis).
- ``moe_ffn_einsum``: GShard one-hot dispatch, the decode path.
- ``moe_ffn_ep``: expert parallelism over a mesh (``dispatch="ep"``
  under ``act_sharding.use_dp_axes(..., mesh=)``), written as three
  local steps (:func:`ep_dispatch`, :func:`ep_experts`,
  :func:`ep_combine`) joined by two ``all_to_all_single`` calls over
  'model', so that a test can chain them across simulated ranks.

On a mesh (DTensor inputs) ``moe_ffn_sort`` and ``moe_ffn_einsum`` run
their data-dependent steps on each rank's local tokens (DTensor has no
sharding rules for a stable sort, ``searchsorted`` or the scatters),
with the experts TP over 'model'.

Router math is fp32. Experts are picked by the JAX tie rule: among equal
router probabilities the lowest expert index wins (a stable descending
sort; ``torch.topk`` does not promise that). A slot's position within
its expert follows the stable order of (token, rank), so the capacity
drops are the reference's. Dropped slots are masked, never scattered:
no write order of duplicate indices is relied on.
"""
from __future__ import annotations

import torch
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F
from torch.distributed.tensor import Partial, Replicate, Shard

from repro_torch.configs.base import MoEConfig
from repro_torch.distributed.act_sharding import (
    TP_AXIS, constrain_spec, dp_bounds, dp_placements, from_local,
    gather_dp, local_weight, mesh_dim)


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
    if hasattr(x, "device_mesh"):
        return _sharded_moe(x, params, cfg, decode=False)
    y, aux, _, _ = _moe_ffn_sort(x, params, cfg)
    return y, aux


def _shared_expert_dp(x: torch.Tensor, params: dict) -> torch.Tensor:
    """Shared-expert SwiGLU with DP-pinned intermediates, as the
    reference's (no-ops on one device)."""
    g = constrain_spec(x @ gather_dp(params["shared_wg"]), ("dp", None))
    u = constrain_spec(x @ gather_dp(params["shared_wu"]), ("dp", None))
    return constrain_spec((F.silu(g) * u) @ gather_dp(params["shared_wd"]),
                          ("dp", None))


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
    if hasattr(x, "device_mesh"):
        return _sharded_moe(x, params, cfg, decode=True)
    y, aux, _, _ = _moe_ffn_einsum(x, params, cfg)
    return y, aux


def moe_ffn(x: torch.Tensor, params: dict, cfg: MoEConfig):
    """The einsum dispatch for ``dispatch == "einsum"``, else the sort
    dispatch ("sort", and "ep" without a mesh, as the reference
    falls back)."""
    if cfg.dispatch == "einsum":
        return moe_ffn_einsum(x, params, cfg)
    return moe_ffn_sort(x, params, cfg)


# ---------------------------------------------------------------------------
# on a mesh: the dispatches on local token shards (DTensor inputs)
# ---------------------------------------------------------------------------

def _n_dp(mesh) -> int:
    n = 1
    for name in mesh.mesh_dim_names:
        if name != TP_AXIS:
            n *= mesh.size(mesh_dim(mesh, name))
    return n


def _tp_experts(params: dict) -> dict:
    """Local expert weights for TP inside the experts: router replicated,
    wg/wu sharded over 'model' on d_ff, wd on its d_ff rows. The
    routing runs on every 'model' rank alike and the expert products
    give partial sums over 'model', so every gradient here is Partial
    over 'model' and over the DP axes."""
    mesh = params["wg"].device_mesh
    out = {"router": local_weight(params["router"].redistribute(
        mesh, [Replicate()] * mesh.ndim), model_partial=True)}
    for n in ("wg", "wu", "wd"):
        out[n] = local_weight(gather_dp(params[n]))
    return out


def _sharded_moe(x, params: dict, cfg: MoEConfig, decode: bool):
    """``moe_ffn_sort`` (or in decode ``moe_ffn_einsum``) of a DTensor x
    (T, d). Sort: the capacity groups are split over the DP axes (the
    reference's group axis on 'data'), each rank dispatching its groups
    locally; the group count must divide over the DP ranks. Einsum (a
    few tokens): the tokens are all-gathered and dispatched whole on
    every rank, so that each slot's position within its expert is the
    reference's, and each rank keeps its own rows. The experts run TP
    over 'model'; y is Partial over 'model' until it is next
    redistributed. The data-dependent sort, searchsorted and gathers run
    on local tensors (DTensor has no rules for them)."""
    mesh = x.device_mesh
    T, d = x.shape
    n_dp = _n_dp(mesh)
    part = dp_placements(mesh, 0, Partial())
    w = _tp_experts(params)
    if decode:
        x_all = x.redistribute(mesh, [Replicate()] * mesh.ndim) \
            .to_local(grad_placements=[Partial()] * mesh.ndim)
        y, aux, _, _ = _moe_ffn_einsum(x_all, w, cfg)
        first, cnt = dp_bounds(mesh, T)
        y = from_local(y[first:first + cnt], mesh, part, (T, d))
        aux = from_local(aux / mesh.size(), mesh,
                         [Partial()] * mesh.ndim, ())
    else:
        g, C = sort_groups(T, cfg)
        if g % n_dp:
            raise ValueError(f"{g} capacity groups do not split over {n_dp} "
                             "data-parallel ranks")
        x_l = x.redistribute(mesh, dp_placements(mesh, 0)).to_local(
            grad_placements=part)
        y, aux, _, _ = _sort_dispatch(x_l.reshape(g // n_dp, -1, d), w, cfg,
                                      C)
        y = from_local(y.reshape(-1, d), mesh, part, (T, d))
        n_model = mesh.size(mesh_dim(mesh, TP_AXIS))
        aux = from_local(aux.sum() / (g * n_model), mesh,
                         [Partial()] * mesh.ndim, ())
    if "shared_wg" in params:
        y = y + _shared_expert_dp(x, params)
    return y, aux


# ---------------------------------------------------------------------------
# expert parallelism (MoEConfig.dispatch="ep" under a mesh)
# ---------------------------------------------------------------------------

def _pad_experts(w: torch.Tensor, e_pad: int) -> torch.Tensor:
    """Pad the expert axis with zero experts (for EP divisibility)."""
    if e_pad == 0:
        return w
    return torch.cat([w, w.new_zeros((e_pad, *w.shape[1:]))], 0)


def ep_dispatch(x: torch.Tensor, router: torch.Tensor, cfg: MoEConfig,
                n_model: int, C: int):
    """EP step 1 on one rank: route its tokens x (T, d) and lay them out
    as the send buffer (n_model, E_loc * C, d): slab j holds, for each
    of the experts [j E_loc, (j + 1) E_loc) that rank j of 'model' owns,
    its first C slots in (token, rank) order (zero rows where an expert
    has fewer; experts are padded to Ep = n_model E_loc, and the pad
    experts get no slot). Returns (send, state for :func:`ep_combine`,
    aux), aux this rank's load-balance loss."""
    T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    E_loc = -(-E // n_model)
    Ep = E_loc * n_model
    N = T * k
    dev = x.device
    idx, weights, probs = router_topk(x, router, k)
    aux = load_balance_loss(probs, idx, E)
    flat_e = idx.reshape(N).long()
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    experts = torch.arange(Ep, device=dev)
    first = torch.searchsorted(sorted_e, experts, side="left")
    count = torch.searchsorted(sorted_e, experts, side="right") - first
    pos_sorted = torch.arange(N, device=dev) - first[sorted_e]
    pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)
    keep = pos < C
    c_ar = torch.arange(C, device=dev)
    src = (first[:, None] + c_ar).clamp_max(N - 1).reshape(-1)
    filled = (c_ar < count[:, None]).reshape(-1, 1)
    send = torch.where(filled, x.index_select(0, order[src] // k), 0)
    state = (flat_e * C + pos.clamp_max(C - 1), keep, weights)
    return send.reshape(n_model, E_loc * C, d), state, aux


def ep_experts(recv: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
               wd: torch.Tensor, C: int) -> torch.Tensor:
    """EP step 2 on the rank owning E_loc experts: recv (n_model, E_loc
    * C, d), slab i from 'model' rank i; wg/wu (E_loc, d, F), wd (E_loc,
    F, d). Each expert runs its SwiGLU over the n_model * C rows sent to
    it; the output goes back in the layout it came in."""
    n_model, _, d = recv.shape
    E_loc = wg.shape[0]
    buf = recv.reshape(n_model, E_loc, C, d).transpose(0, 1) \
        .reshape(E_loc, n_model * C, d)
    out = _experts(buf, {"wg": wg, "wu": wu, "wd": wd})
    return out.reshape(E_loc, n_model, C, d).transpose(0, 1) \
        .reshape(n_model, E_loc * C, d)


def ep_combine(back: torch.Tensor, state, dtype) -> torch.Tensor:
    """EP step 3 on the sending rank: back (n_model, E_loc * C, d) the
    experts' outputs for its slots, in its send layout; each token sums
    its kept slots' outputs weighted by the router (a dropped slot gives
    0), in the compute dtype, as the reference does."""
    slot_row, keep, weights = state
    d = back.shape[-1]
    T, k = weights.shape
    y = torch.where(keep[:, None], back.reshape(-1, d)
                    .index_select(0, slot_row), 0)
    return torch.einsum("tkd,tk->td", y.reshape(T, k, d),
                        weights.to(dtype))


def moe_ffn_ep(x, params: dict, cfg: MoEConfig, mesh):
    """True expert parallelism: tokens all-to-all to expert owners.

    x (T, d) a DTensor on ``mesh``. Tokens are sharded over every mesh
    axis; experts are padded to a multiple of the 'model' axis and rank
    j of 'model' owns experts [j E_loc, (j + 1) E_loc) (DTensor's Shard
    of the E experts over 'model' gives exactly these; the last ranks'
    shards are short or empty, and the missing ones are zero experts).
    Per rank: :func:`ep_dispatch` of its T_loc tokens with capacity
    ``capacity(T_loc, k, E, factor)``, one ``all_to_all_single`` over
    'model' (slab j to rank j), :func:`ep_experts`, one
    ``all_to_all_single`` back, :func:`ep_combine`. The interconnect
    carries the token slabs instead of activation-partial all-reduces.
    aux is the mean over every rank (the reference's ``pmean``s). The
    shared expert runs as in ``moe_ffn_sort``. Returns (y (T, d)
    sharded over every axis, aux)."""
    T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    md = mesh_dim(mesh, TP_AXIS)
    n_model = mesh.size(md)
    n_all = mesh.size()
    T_loc = T // n_all
    C = capacity(T_loc, k, E, cfg.capacity_factor)
    E_loc = -(-E // n_model)
    tok = [Shard(0)] * mesh.ndim
    x_l = x.redistribute(mesh, tok).to_local()
    router = local_weight(params["router"].redistribute(
        mesh, [Replicate()] * mesh.ndim), model_partial=True)
    owned = [Shard(0) if i == md else Replicate()
             for i in range(mesh.ndim)]
    ws = []
    for n in ("wg", "wu", "wd"):
        w = local_weight(params[n].redistribute(mesh, owned))
        ws.append(_pad_experts(w, E_loc - w.shape[0]))
    group = (mesh, md)
    send, state, aux = ep_dispatch(x_l, router, cfg, n_model, C)
    recv = funcol.all_to_all_single_autograd(
        send.reshape(-1, d), None, None, group).reshape(send.shape)
    out = ep_experts(recv, *ws, C)
    back = funcol.all_to_all_single_autograd(
        out.reshape(-1, d), None, None, group).reshape(out.shape)
    y = from_local(ep_combine(back, state, x_l.dtype), mesh, tok, (T, d))
    aux = from_local(aux / n_all, mesh, [Partial()] * mesh.ndim, ())
    if "shared_wg" in params:
        y = y + _shared_expert_dp(x, params)
    return y, aux
