"""Per-family sharding rules for params, optimizer state, inputs and
outputs, as DTensor placements (port of
``repro/distributed/sharding.py``).

The rules are the reference's, written as :class:`P` specs (its
``PartitionSpec``: one entry a tensor dim, each ``None``, a mesh axis
name or a tuple of names) and turned into DTensor placements on a
``DeviceMesh`` by :func:`placements`:

- LM: FSDP ('data' on the d_model-ish dim) x TP ('model' on the d_ff /
  fused-head / vocab dim). Attention-head axes are never the sharded
  dim; the fused head*dim axis is (``models/transformer.py`` regroups
  whole heads before its kernels).
- MoE experts: TP *within* experts (expert d_ff over 'model'); the
  expert-parallel route (``moe_ffn_ep``) reshards the experts itself.
- decode KV caches: batch over the DP axes, *sequence* over 'model'.
- GNN: edges sharded over every axis, weights and node features
  replicated.
- RecSys: tables of >= 4096 rows row-sharded over 'model', batch over
  the DP axes.
- 'pod': pure DP; params are replicated across pods.

The port keeps the reference's parameter layout: an LM's per-layer
weights are stacked on a leading L axis (``transformer.init_params``,
unbound once a pass by ``_layer_params``), so a layer rule ``spec``
becomes ``P(None, *spec)`` as in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard

from repro_torch.configs.base import GNNConfig, LMConfig, RecSysConfig
from repro_torch.tree import flatten_with_path, leaves, tree_map, unflatten


class P:
    """The reference's ``PartitionSpec``: ``P("data", "model")``; an
    entry is None (replicated), an axis name, or a tuple of axis names
    (the dim split over several mesh axes, the first the major one).
    Trailing dims not named are replicated; a one-name tuple is the name
    (as JAX normalizes it). Not a tuple, so that the tree helpers
    (``repro_torch.tree``) take a spec as one leaf."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(e[0] if isinstance(e, tuple) and len(e) == 1
                             else e for e in entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, P) and self.entries == other.entries

    def __hash__(self) -> int:
        return hash(self.entries)

    def __repr__(self) -> str:
        return f"P{self.entries!r}"


def placements(mesh, spec: P) -> list:
    """DTensor placements on ``mesh`` for ``spec``: a dim named by one
    or several mesh axes is ``Shard(dim)`` on each of those mesh dims
    (several must be in mesh order, as the reference's ``dp`` tuples
    are); every other mesh dim is ``Replicate()``. Raises when an axis is
    not in the mesh, appears on two dims, or a tuple is out of mesh
    order."""
    names = list(mesh.mesh_dim_names)
    out: list[Placement] = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = []
        for a in axes:
            if a not in names:
                raise ValueError(f"{spec}: axis {a!r} is not in the mesh's "
                                 f"{tuple(names)}")
            i = names.index(a)
            if not isinstance(out[i], Replicate):
                raise ValueError(f"{spec}: axis {a!r} shards two dims")
            out[i] = Shard(dim)
            idx.append(i)
        if idx != sorted(idx):
            raise ValueError(f"{spec}: axes {axes} are not in mesh order "
                             f"{tuple(names)}")
    return out


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``NamedSharding``)."""
    mesh: Any
    spec: P

    @property
    def placements(self) -> list:
        return placements(self.mesh, self.spec)


def tree_shardings(mesh, spec_tree):
    return tree_map(lambda s: NamedSharding(mesh, s), spec_tree)


def distribute(x, sharding: NamedSharding, device=None,
               dtype: torch.dtype | None = None) -> DTensor:
    """``x`` (a tensor or a numpy array, the same global value on every
    rank) as a DTensor placed by ``sharding``, its local shard on
    ``device`` (default: the mesh's device type, the rank's card for
    ``cuda``) in ``dtype`` (default ``x``'s). Each rank narrows ``x`` to
    its own block (DTensor's ``Shard`` split: ceil(n / size) a rank,
    mesh dims in order; no traffic) and copies that block, unless it is
    all of ``x``: a one-rank mesh wraps ``x`` itself, with no second
    copy of a 30 GB cache. A meta tensor gives a DTensor of meta shards
    (nothing allocated)."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(np.asarray(x)))
    mesh = sharding.mesh
    if dtype is not None:
        t = t.to(dtype)
    if device is not None:
        t = t.to(device)
    elif t.device.type not in ("meta", mesh.device_type):
        t = t.to(mesh.device_type if mesh.device_type != "cuda"
                 else torch.cuda.current_device())
    pl = sharding.placements
    local = t
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            n, size = local.shape[p.dim], mesh.size(i)
            step = -(-n // size)
            first = min(mesh.get_local_rank(i) * step, n)
            local = local.narrow(p.dim, first, min(step, n - first))
    if local.numel() != t.numel():
        # a block of a larger tensor gets a storage of its own: a view
        # would hold (and a counter would count) the whole tensor
        local = local.clone(memory_format=torch.contiguous_format)
    from repro_torch.distributed.act_sharding import from_local
    return from_local(local, mesh, pl, tuple(t.shape))


def distribute_tree(tree, mesh, spec_tree, device=None,
                    dtype: torch.dtype | None = None):
    """Place every leaf of ``tree`` (tensors or numpy arrays: the JAX
    package's parameters as numpy arrays reach the sharded port this
    way) on ``mesh`` by the matching spec of ``spec_tree``; see
    :func:`distribute`. Leaves of an integer or bool dtype keep it when
    ``dtype`` is given."""
    specs, flat = leaves(spec_tree), leaves(tree)
    if len(specs) != len(flat):
        raise ValueError(f"spec tree has {len(specs)} leaves, tree "
                         f"{len(flat)}")
    out = []
    for x, s in zip(flat, specs):
        floating = np.issubdtype(np.asarray(x).dtype, np.floating) \
            if not isinstance(x, torch.Tensor) else x.is_floating_point()
        out.append(distribute(x, NamedSharding(mesh, s), device,
                              dtype if floating else None))
    return unflatten(tree, out)


# ---------------------------------------------------------------------------
# LM
# ---------------------------------------------------------------------------

_LM_LAYER_RULES = {
    # name -> spec for the per-layer shape, EXCLUDING the leading L axis
    "wq": P("data", "model"),
    "wk": P("data", "model"),
    "wv": P("data", "model"),
    "wo": P("model", "data"),
    "ln1": P(None), "ln2": P(None),
    "q_norm": P(None), "k_norm": P(None),
    # dense ffn
    "wg": P("data", "model"), "wu": P("data", "model"),
    "wd": P("model", "data"),
    # moe (expert axis replicated; TP inside the expert)
    "router": P("data", None),
    "shared_wg": P("data", "model"), "shared_wu": P("data", "model"),
    "shared_wd": P("model", "data"),
}

_LM_MOE_RULES = {  # (E, d, f) / (E, f, d) expert stacks
    "wg": P(None, "data", "model"), "wu": P(None, "data", "model"),
    "wd": P(None, "model", "data"),
}


def lm_param_specs(cfg: LMConfig) -> dict:
    """Spec tree matching ``transformer.init_params``."""
    from repro_torch.models.transformer import _layer_shapes
    layer = {}
    for name, shp in _layer_shapes(cfg).items():
        if cfg.is_moe and name in _LM_MOE_RULES and len(shp) == 3:
            spec = _LM_MOE_RULES[name]
        else:
            spec = _LM_LAYER_RULES[name]
        layer[name] = P(None, *spec)           # leading stacked-layer axis
    out = {"layers": layer,
           "embed": P("model", "data"),
           "final_ln": P(None)}
    if not cfg.tie_embeddings:
        out["unembed"] = P("data", "model")
    return out


def opt_specs(param_specs) -> dict:
    """AdamW state ({"mu", "nu", "master", "step"}) placed as the
    parameters; the step replicated."""
    return {"mu": param_specs, "nu": param_specs, "master": param_specs,
            "step": P()}


def lm_batch_spec(mesh) -> dict:
    dp = _dp(mesh)
    return {"tokens": P(dp, None), "labels": P(dp, None)}


def lm_cache_spec(mesh) -> dict:
    dp = _dp(mesh)
    return {"k": P(None, dp, "model", None, None),
            "v": P(None, dp, "model", None, None),
            "length": P(dp)}


def lm_prefill_out_spec(mesh):
    dp = _dp(mesh)
    return (P(dp, "model"), lm_cache_spec(mesh))    # (logits, cache)


# ---------------------------------------------------------------------------
# GNN
# ---------------------------------------------------------------------------

def gnn_param_specs(cfg: GNNConfig, params_shape) -> Any:
    # GNN weights are small: replicate.
    return tree_map(lambda _: P(), params_shape)


def gnn_batch_spec(mesh, kind: str, n_levels: int = 2) -> dict:
    dp = _dp(mesh)
    all_axes = tuple(mesh.mesh_dim_names)
    if kind == "full_graph":
        return {"feats": P(None, None), "edges": P(all_axes, None),
                "labels": P(None), "label_mask": P(None)}
    if kind == "minibatch":
        spec = {"labels": P(dp)}
        for i in range(n_levels + 1):
            spec[f"feat_l{i}"] = P(dp, *([None] * (i + 1)))
        return spec
    if kind == "batched_graphs":
        return {"feats": P(dp, None, None), "edges": P(dp, None, None),
                "edge_mask": P(dp, None), "labels": P(dp)}
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# RecSys
# ---------------------------------------------------------------------------

def recsys_param_specs(cfg: RecSysConfig, params_shape) -> Any:
    """Row-shard every large embedding table over 'model'; replicate the
    dense interaction weights (they are tiny)."""
    big = ("item_emb", "tables", "wide")
    paths = flatten_with_path(params_shape)

    def rule(path, leaf):
        name = "/".join(path)
        if any(b in name for b in big) and leaf.ndim == 2 \
                and leaf.shape[0] >= 4096:
            return P("model", None)
        return P()
    return unflatten(params_shape, [rule(p, l) for p, l in paths])


def recsys_batch_spec(mesh, cfg: RecSysConfig, kind: str) -> dict:
    dp = _dp(mesh)
    b1 = P(dp)
    bN = P(dp, None)
    if kind == "retrieval":
        out = {"cand_ids": P("model")}
        if cfg.kind == "wide_deep":
            out.update({"sparse_ids": P(None, None, None),
                        "sparse_mask": P(None, None, None)})
        else:
            out["seq"] = P(None, None)
        return out
    if cfg.kind == "sasrec":
        out = {"seq": bN}
        if kind == "train":
            out.update({"pos": bN, "neg": bN})
        else:
            out["cands"] = bN
        return out
    if cfg.kind == "mind":
        out = {"seq": bN}
        if kind == "train":
            out.update({"pos": b1, "neg": bN})
        else:
            out["cands"] = bN
        return out
    if cfg.kind == "bst":
        out = {"seq": bN}
        if kind == "train":
            out.update({"target": b1, "label": b1})
        else:
            out["cands"] = bN
        return out
    if cfg.kind == "wide_deep":
        out = {"sparse_ids": P(dp, None, None),
               "sparse_mask": P(dp, None, None)}
        if kind == "train":
            out["label"] = b1
        else:
            out["cands"] = bN
        return out
    raise ValueError(cfg.kind)


def _dp(mesh) -> tuple:
    from repro_torch.launch.mesh import dp_axes
    return dp_axes(mesh)


__all__ = ["NamedSharding", "P", "distribute", "distribute_tree",
           "gnn_batch_spec", "gnn_param_specs", "lm_batch_spec",
           "lm_cache_spec", "lm_param_specs", "lm_prefill_out_spec",
           "opt_specs", "placements", "recsys_batch_spec",
           "recsys_param_specs", "tree_shardings"]
