"""The shard mesh of the sharded serving path (port of
``repro/launch/mesh.py:make_shard_mesh``).

The reference builds a 1-D ``jax`` mesh named ``model`` and runs every
sharded lookup under ``shard_map``. The port has one controller: a
:class:`ShardMesh` only says which device holds each shard, and
``index/sharded.py`` loops over the shards, each on its own device's
current stream. Several shards may share one device (on a host with one
card, every shard sits on ``cuda:0``); the code path is the one that
runs across cards.

``make_production_mesh``, ``make_smoke_mesh`` and ``dp_axes`` serve the
reference's XLA dry runs and training; they are not ported here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Tuple

import torch

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
