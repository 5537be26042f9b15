"""Activation sharding constraints on DTensors (port of
``repro/distributed/act_sharding.py``).

The reference pins activations with ``with_sharding_constraint`` so that
GSPMD all-gathers the FSDP-sharded weights instead of resharding the
activations onto a weight's contraction dimension. The port's
counterpart is a DTensor ``redistribute`` to the placements that the
reference's ``PartitionSpec`` names (``distributed/sharding.placements``);
the weights are all-gathered over the data-parallel axes explicitly
(:func:`gather_dp`) before each product, which is the FSDP execution the
constraints aim at.

The data-parallel axes and the mesh are threaded through context
variables, as in the reference, so model code stays mesh-agnostic;
``use_dp_axes(...)`` is entered where the mesh is known (the workload
builders, the training launcher). The tensor-parallel axis is the
framework-wide convention ``"model"``. Every constraint is a no-op
outside a context and on a plain tensor, so the one-device path runs
unchanged.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.distributed.sharding import P, placements

_DP_AXES = contextvars.ContextVar("repro_torch_dp_axes", default=None)
_MESH = contextvars.ContextVar("repro_torch_mesh", default=None)
TP_AXIS = "model"


@contextlib.contextmanager
def use_dp_axes(axes, mesh=None):
    tok = _DP_AXES.set(tuple(axes) if axes else None)
    tok2 = _MESH.set(mesh)
    try:
        yield
    finally:
        _DP_AXES.reset(tok)
        _MESH.reset(tok2)


def current_mesh():
    return _MESH.get()


def dp_axes_active():
    return _DP_AXES.get()


def _to_spec(x, spec: P):
    """Redistribute DTensor ``x`` to ``spec`` on its own mesh (a no-op
    when it is there already, or when ``x`` is a plain tensor)."""
    if not isinstance(x, DTensor):
        return x
    want = placements(x.device_mesh, spec)
    if tuple(x.placements) == tuple(want):
        return x
    return x.redistribute(x.device_mesh, want)


def constrain_act(x):
    """Pin the leading (batch-like) axis to the DP axes, the rest
    replicated."""
    axes = _DP_AXES.get()
    if axes is None:
        return x
    return _to_spec(x, P(axes, *([None] * (x.ndim - 1))))


def constrain_tp_last(x):
    """Batch on the DP axes, last axis on the TP ('model') axis."""
    axes = _DP_AXES.get()
    if axes is None:
        return x
    return _to_spec(x, P(axes, *([None] * (x.ndim - 2)), TP_AXIS))


def constrain_seq(x):
    """Megatron-SP layout: batch on the DP axes, *sequence* axis on
    'model' (the layer carry, which remat keeps, sharded over the TP
    axis)."""
    axes = _DP_AXES.get()
    if axes is None:
        return x
    return _to_spec(x, P(axes, TP_AXIS, *([None] * (x.ndim - 2))))


def constrain_spec(x, spec_tokens):
    """General constraint: entries 'dp' (the DP axes), 'model' (TP axis)
    or None. No-op outside a DP context."""
    axes = _DP_AXES.get()
    if axes is None:
        return x
    parts = [axes if t == "dp" else TP_AXIS if t == "model" else None
             for t in spec_tokens]
    return _to_spec(x, P(*parts))


# ---------------------------------------------------------------------------
# the DTensor plumbing the model code shares
# ---------------------------------------------------------------------------

def gather_dp(w):
    """The FSDP all-gather of a weight: its shards over the data-parallel
    mesh axes ('pod', 'data') become replicas, its 'model' placement
    stays. A plain tensor is returned as it is."""
    if not isinstance(w, DTensor):
        return w
    mesh = w.device_mesh
    want = [Replicate() if name in ("pod", "data") else pl
            for name, pl in zip(mesh.mesh_dim_names, w.placements)]
    if want == list(w.placements):
        return w
    return w.redistribute(mesh, want)


def replicated(t: torch.Tensor, like):
    """``t`` (a plain tensor, the same on every rank: a rotary table, an
    iota) as a replicated DTensor on ``like``'s mesh when ``like`` is a
    DTensor; else ``t`` itself."""
    if not isinstance(like, DTensor) or isinstance(t, DTensor):
        return t
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def local_of(t):
    """A DTensor's local shard (what this rank holds); a plain tensor
    itself."""
    return t.to_local() if isinstance(t, DTensor) else t


def dp_placements(mesh, dim: int = 0, model=None) -> list:
    """Placements with ``dim`` sharded over the mesh's data-parallel
    axes and ``model`` (default ``Replicate()``) on the 'model' axis."""
    return [Shard(dim) if n in ("pod", "data")
            else (model or Replicate()) if n == TP_AXIS else Replicate()
            for n in mesh.mesh_dim_names]


def from_local(t: torch.Tensor, mesh, pl, shape) -> DTensor:
    """``DTensor.from_local`` of ``t`` made contiguous, with the global
    ``shape`` given (so that an uneven shard, or a Partial one, is not
    sized by guess) and contiguous strides."""
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return DTensor.from_local(t.contiguous(), mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=tuple(reversed(stride)))


def local_rows(shard: torch.Tensor, first: int,
               ids: torch.Tensor) -> torch.Tensor:
    """One rank's part of ``table[ids]`` when it holds rows [first, first
    + len(shard)) of the table: the rows of the ids in that range, zero
    for the others (summed over the ranks, the whole lookup)."""
    cnt = shard.shape[0]
    loc = ids.long() - first
    ok = (loc >= 0) & (loc < cnt)
    if not cnt:
        return shard.new_zeros((*ids.shape, shard.shape[1]))
    return torch.where(ok[..., None], shard[loc.clamp(0, cnt - 1)], 0)


def embed_rows(table, ids):
    """``table[ids]``. For a DTensor ``table`` whose rows are sharded over
    'model' (an LM's embedding, a recsys table), each rank gathers the
    ids in its row range from its shard, zero elsewhere, and the result
    is Partial over 'model' (summed where it is next redistributed):
    the vocab-parallel lookup, with no table gathered. A table with
    replicated rows is looked up locally. Column shards over the DP
    axes are all-gathered first (FSDP). The result is placed as
    ``ids`` (a plain ``ids`` is taken as replicated); ids sharded over
    'model' (retrieval candidates) are all-gathered over it first and
    the rows reduce-scattered back."""
    if not isinstance(table, DTensor):
        return table[ids.long()]
    mesh = table.device_mesh
    t = gather_dp(table)
    ids = replicated(ids, table)
    md = mesh_dim(mesh, TP_AXIS)
    want = list(ids.placements)
    if not isinstance(want[md], Replicate):   # ids sharded over 'model'
        pl = want[:md] + [Replicate()] + want[md + 1:]
        ids = ids.redistribute(mesh, pl)
    pl = list(ids.placements)
    ids_l = ids.to_local().long()
    t_l = local_weight(t)
    if isinstance(t.placements[md], Shard) and t.placements[md].dim == 0:
        first, _ = shard_bounds(mesh, TP_AXIS, table.shape[0])
        rows = local_rows(t_l, first, ids_l)
        pl[md] = Partial()
    else:
        rows = t_l[ids_l]
    out = from_local(rows, mesh, pl, (*ids.shape, table.shape[-1]))
    if want != list(ids.placements):          # back to the ids' layout
        out = out.redistribute(mesh, want)
    return out


def local_weight(w, model_partial: bool = False) -> torch.Tensor:
    """The local shard of a weight DTensor used on this rank's tokens:
    its gradient there is this rank's share, so the gradient placements
    are Partial on the data-parallel axes where the weight is replicated
    (and on 'model' too with ``model_partial``, where the model ranks'
    computations are partial sums); the backward of the FSDP gather
    then reduce-scatters it. A plain tensor is returned as it is."""
    if not isinstance(w, DTensor):
        return w
    names = w.device_mesh.mesh_dim_names
    grad = [Partial() if isinstance(p, Replicate) and (
        n in ("pod", "data") or (model_partial and n == TP_AXIS)) else p
        for n, p in zip(names, w.placements)]
    return w.to_local(grad_placements=grad)


def dp_bounds(mesh, n: int) -> tuple:
    """(first, count) of this rank's rows of ``n`` rows sharded over the
    data-parallel axes in mesh order (``dp_placements``)."""
    idx, size = 0, 1
    for name in mesh.mesh_dim_names:
        if name != TP_AXIS:
            k = mesh.size(mesh_dim(mesh, name))
            idx = idx * k + mesh.get_local_rank(name)
            size *= k
    step = -(-n // size)
    first = min(idx * step, n)
    return first, min(step, n - first)


def gather_over(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """All-gather the plain tensor ``t`` over mesh axis ``axis`` along
    dim 0 (a functional collective, waited on): the ranks' tensors in
    rank order."""
    import torch.distributed._functional_collectives as funcol
    gather = getattr(funcol, "all_gather_single", None) \
        or funcol.all_gather_tensor         # the name before torch 2.13
    return funcol.wait_tensor(gather(t.contiguous(), 0,
                                     (mesh, mesh_dim(mesh, axis))))


def all_reduce_over(t: torch.Tensor, mesh, op: str) -> torch.Tensor:
    """All-reduce the plain tensor ``t`` by ``op`` ("sum" or "max")
    over every axis of ``mesh``, one axis after the other (functional
    collectives, waited on): the same result on every rank."""
    import torch.distributed._functional_collectives as funcol
    for d in range(mesh.ndim):
        t = funcol.wait_tensor(funcol.all_reduce(t.contiguous(), op,
                                                 (mesh, d)))
    return t


def mesh_dim(mesh, axis: str) -> int:
    return list(mesh.mesh_dim_names).index(axis)


def shard_bounds(mesh, axis: str, n: int) -> tuple:
    """(first, count) of this rank's rows when ``n`` rows are sharded
    over ``axis`` as DTensor's ``Shard`` splits them (``torch.chunk``:
    ceil(n / size) a rank, the last ranks short or empty)."""
    size = mesh.size(mesh_dim(mesh, axis))
    r = mesh.get_local_rank(axis)
    step = -(-n // size)
    first = min(r * step, n)
    return first, min(step, n - first)


__all__ = ["TP_AXIS", "all_reduce_over", "constrain_act", "constrain_seq",
           "constrain_spec", "constrain_tp_last", "current_mesh", "dp_axes_active",
           "dp_bounds", "dp_placements", "embed_rows", "from_local",
           "gather_dp", "gather_over", "local_of", "local_rows", "local_weight",
           "mesh_dim", "replicated", "shard_bounds", "use_dp_axes"]
