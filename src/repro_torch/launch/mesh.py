"""Meshes (port of ``repro/launch/mesh.py``).

Two kinds, as in the reference:

- the shard mesh of the sharded serving path
  (:func:`make_shard_mesh`). The reference builds a 1-D ``jax`` mesh
  named ``model`` and runs every sharded lookup under ``shard_map``. The
  port has one controller: a :class:`ShardMesh` only says which device
  holds each shard, and ``index/sharded.py`` loops over the shards, each
  on its own device's current stream. Several shards may share one
  device (on a host with one card, every shard sits on ``cuda:0``); the
  code path is the one that runs across cards;
- the training and dry-run meshes (:func:`make_production_mesh`,
  :func:`make_smoke_mesh`, :func:`dp_axes`): a
  ``torch.distributed.device_mesh.DeviceMesh`` over the default process
  group, one rank a device, on which ``distributed/sharding.py`` places
  parameters and batches as DTensors. The group is the caller's: NCCL
  on cards (device type ``cuda``), gloo on the CPU or the ``"fake"``
  group of the dry run (device type ``cpu``). A mesh function never
  starts a group; without one, or with one of another size, it raises.
  On a ``cpu``-typed mesh DTensor's own Shard-to-Shard redistribute
  falls back to an all-gather and a chunk (gloo has no all-to-all);
  ``analysis/counter.ProgramCounter`` runs it on meta tensors as the
  one all-to-all it is on cards, so a counted mesh counts it as such.
  The MoE's expert exchange calls ``all_to_all_single`` itself and
  stays one all-to-all on every group.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import get_device


@dataclass(frozen=True)
class ShardMesh:
    """A 1-D mesh: ``devices[s]`` holds shard ``s`` along ``axis``.
    ``mesh.shape[axis]`` is the shard count, as on a ``jax`` mesh."""
    axis: str
    devices: Tuple[torch.device, ...]

    @property
    def shape(self) -> Mapping[str, int]:
        return {self.axis: len(self.devices)}


def make_shard_mesh(n_shards: int, device=None) -> ShardMesh:
    """``n_shards`` shards along the ``model`` axis, as the reference's
    mesh. By default (``device`` None or ``"cuda"``) shard ``s`` goes on
    ``cuda:(s % device_count())``; ``device="cpu"`` puts every shard on
    the CPU, ``device="meta"`` on the meta device (for a counted dry
    run). Asking for CUDA on a host without a card raises, as every
    entry point of the port does."""
    if n_shards < 1:
        raise ValueError(f"n_shards={n_shards} < 1")
    dev = get_device(device)
    if dev.type != "cuda":
        return ShardMesh("model", (dev,) * n_shards)
    n = torch.cuda.device_count()
    return ShardMesh("model", tuple(torch.device("cuda", s % n)
                                    for s in range(n_shards)))


def _group_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]) -> DeviceMesh:
    """A DeviceMesh of ``shape`` named ``axes`` over the default process
    group, which must exist and hold exactly prod(shape) ranks."""
    n = 1
    for a in shape:
        n *= a
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {shape} mesh needs a default process group of {n} ranks: "
            "start one with torch.distributed.init_process_group (NCCL on "
            "cards, gloo on the CPU, 'fake' for a counted dry run); a mesh "
            "never starts one itself")
    if dist.get_world_size() != n:
        raise ValueError(f"a {shape} mesh needs {n} ranks; the default "
                         f"process group has {dist.get_world_size()}")
    dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(dev, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """16x16 ``("data", "model")`` (256 ranks) or 2x16x16 ``("pod",
    "data", "model")`` (512 ranks). Axis semantics as the reference's:
    'pod' pure data parallelism, 'data' data parallel / FSDP shard axis,
    'model' tensor / expert / sequence parallel axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _group_mesh(shape, axes)


def make_smoke_mesh(n_devices: int | None = None) -> DeviceMesh:
    """A ``("data", "model")`` mesh over ``n_devices`` ranks (default:
    the group's size): model 2 when n is even, else 1, as the
    reference's."""
    n = n_devices or (dist.get_world_size() if dist.is_initialized() else 0)
    if n < 1:
        raise RuntimeError("make_smoke_mesh needs a default process group "
                           "(torch.distributed.init_process_group)")
    model = 2 if n % 2 == 0 else 1
    return _group_mesh((n // model, model), ("data", "model"))


def dp_axes(mesh) -> tuple:
    """Mesh axes used for batch/data parallelism."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))
