"""Concrete single-card workloads: the recsys part of
``repro/launch/workloads.py``.

The JAX builder is abstract: it returns ``ShapeDtypeStruct`` stand-ins
and mesh shardings for a dry-run lowering, and allocates nothing. This
is its concrete counterpart on one card: a :class:`Workload` holds the
function, real parameters from a seed and a real batch on the device,
ready to call as ``wl.fn(*wl.args)``.

Ported: every recsys kind (SASRec, MIND, BST, Wide&Deep) at every
shape of ``RECSYS_SHAPES``: ``train_batch`` (one AdamW step),
``serve_p99``, ``serve_bulk`` and ``retrieval_cand``. The LM and GNN
workloads raise ``NotImplementedError`` naming their ROADMAP.md item.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Iterator, Tuple

import torch

from repro_torch.configs import get_arch, get_shape
from repro_torch.configs.base import RecSysConfig, ShapeSpec
from repro_torch.data.recsys_data import recsys_batches
from repro_torch.device import get_device
from repro_torch.models import recsys
from repro_torch.training import optimizer as opt

ADAMW = opt.AdamWConfig()

# arch ids of the JAX registry whose workloads the port has no model for
_UNPORTED_ARCHS = {"graphsage-reddit": "models/gnn.py"}
_ROADMAP = "ROADMAP.md queue 1, \"Remaining workloads\""


@dataclass
class Workload:
    name: str
    fn: Callable                  # positional args
    # (params, batch), or (params, opt_state, batch) for a train step;
    # tensors on the device
    args: Tuple[Any, ...]
    model_flops: float            # model-level useful flops of one call
    arch: str
    shape: str
    # further batches of the same shape from the same seeded stream, on
    # the device (``args`` holds the first)
    batches: Iterator[dict]


# ---------------------------------------------------------------------------
# RecSys workloads
# ---------------------------------------------------------------------------

SERVE_SLATE = {"sasrec": 100, "mind": 100, "bst": 1, "wide_deep": 1}


def _recsys_flops(cfg: RecSysConfig, shape: ShapeSpec) -> float:
    d = cfg.embed_dim
    if cfg.kind in ("sasrec", "mind", "bst"):
        S = cfg.seq_len + (1 if cfg.kind == "bst" else 0)
        blocks = max(cfg.n_blocks, 1)
        per_ex = blocks * (8 * S * d * d + 4 * S * S * d) \
            + sum(a * b * 2 for a, b in zip(
                ((cfg.seq_len + 1) * d,) + tuple(cfg.mlp_dims),
                tuple(cfg.mlp_dims) + (1,))) * (cfg.kind == "bst")
        if cfg.kind == "mind":
            per_ex = cfg.capsule_iters * 4 * S * cfg.n_interests * d \
                + 2 * S * d * d
    else:
        dims = (cfg.n_sparse * d,) + tuple(cfg.mlp_dims) + (1,)
        per_ex = sum(a * b * 2 for a, b in zip(dims[:-1], dims[1:]))
    if shape.kind == "train":
        return 3.0 * per_ex * shape.global_batch
    if shape.kind == "serve":
        slate = SERVE_SLATE[cfg.kind]
        mult = slate if cfg.kind == "bst" else 1
        return per_ex * shape.global_batch * mult
    # retrieval: encode once + dot against all candidates
    return per_ex + 2.0 * shape.n_candidates * cfg.embed_dim


def _input_keys(cfg: RecSysConfig, kind: str) -> Tuple[str, ...]:
    """The keys of ``recsys_batches`` that the JAX package's abstract
    batch (``_recsys_batch``) holds for a shape of ``kind``: the model's
    inputs, and for ``train`` its targets too."""
    if kind == "train":
        return {"sasrec": ("seq", "pos", "neg"),
                "mind": ("seq", "pos", "neg"),
                "bst": ("seq", "target", "label"),
                "wide_deep": ("sparse_ids", "sparse_mask", "label")}[cfg.kind]
    return ("sparse_ids", "sparse_mask") if cfg.kind == "wide_deep" \
        else ("seq",)


def build_recsys(cfg: RecSysConfig, shape: ShapeSpec, device=None,
                 seed: int = 0) -> Workload:
    """Parameters from ``recsys.init_params`` with a generator ``gen`` on
    the device seeded by ``seed``; batches of ``shape.global_batch`` rows
    from ``recsys_batches(cfg, B, seed)`` with the keys the JAX package's
    abstract batch has. Besides:

    - ``train``: ``fn`` is ``optimizer.make_train_step(train_loss,
      AdamWConfig())`` and ``args`` are (params, opt_state, batch), the
      state from ``optimizer.init``;
    - ``serve`` (SASRec, MIND, BST): ``cands`` (B, ``SERVE_SLATE[kind]``)
      int32, drawn uniformly in [1, n_items] by ``torch.randint`` from
      ``gen`` (after the parameters), anew for each batch;
    - ``retrieval``: ``cand_ids``, a permutation of the item ids
      1..n_items drawn from ``gen`` (repeated to ``shape.n_candidates``
      when that is larger, as in a smoke config), the same in every
      batch."""
    dev = get_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = recsys.init_params(cfg, gen, dev)
    keys = _input_keys(cfg, shape.kind)
    slate = SERVE_SLATE[cfg.kind] \
        if shape.kind == "serve" and cfg.kind != "wide_deep" else 0
    cand_ids = None
    if shape.kind == "retrieval":
        n = shape.n_candidates
        perm = torch.randperm(cfg.n_items, generator=gen, device=dev) + 1
        cand_ids = perm.repeat(-(-n // cfg.n_items))[:n] \
            .to(torch.int32).contiguous()

    def batches():
        for b in recsys_batches(cfg, shape.global_batch, seed):
            out = recsys.batch_from_numpy({k: b[k] for k in keys}, dev)
            if slate:
                out["cands"] = torch.randint(
                    1, cfg.n_items + 1, (shape.global_batch, slate),
                    generator=gen, device=dev, dtype=torch.int32)
            if cand_ids is not None:
                out["cand_ids"] = cand_ids
            yield out

    stream = batches()
    name = f"{cfg.name}:{shape.name}"
    flops = _recsys_flops(cfg, shape)
    if shape.kind == "train":
        step = opt.make_train_step(
            lambda p, b: recsys.train_loss(cfg, p, b), ADAMW)
        return Workload(name, step, (params, opt.init(params, ADAMW),
                                     next(stream)),
                        flops, cfg.name, shape.name, stream)
    if shape.kind == "serve":
        def fn(p, b):
            return recsys.serve_scores(cfg, p, b)
    else:
        def fn(p, b):
            return recsys.retrieval(cfg, p, b, k=100)
    return Workload(name, fn, (params, next(stream)), flops, cfg.name,
                    shape.name, stream)


# ---------------------------------------------------------------------------
# entry
# ---------------------------------------------------------------------------

def build_workload(arch_id: str, shape_name: str, device=None,
                   seed: int = 0) -> Workload:
    """The concrete workload of one (arch, shape) cell on ``device``
    (default ``cuda``)."""
    if arch_id in _UNPORTED_ARCHS:
        raise NotImplementedError(
            f"{arch_id}: {_UNPORTED_ARCHS[arch_id]} is not ported yet "
            f"({_ROADMAP})")
    cfg = get_arch(arch_id)
    shape = get_shape(cfg, shape_name)
    if isinstance(cfg, RecSysConfig):
        return build_recsys(cfg, shape, device, seed)
    raise NotImplementedError(
        f"{arch_id}: LM workloads of launch/workloads.py are not ported "
        f"yet ({_ROADMAP}); the port serves LMs through launch/serve.py")


__all__ = ["ADAMW", "SERVE_SLATE", "Workload", "build_recsys",
           "build_workload"]
