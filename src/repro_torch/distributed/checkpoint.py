"""Checkpoint save with integrity manifests (port of
``repro/distributed/checkpoint.py``).

Layout: <dir>/step_<N>/
    manifest.json        {paths, shapes, dtypes, blake2s hashes, step}
    <leaf-path>.npy      one file per leaf

A tree is nested dicts and lists whose leaves are tensors or numpy
arrays. Leaves are named and ordered as the reference names them
(``jax.tree_util.tree_flatten_with_path``: dict keys sorted, list items
by position, joined by ``/``, so ``mlp[0]["w"]`` is ``mlp/0/w``), and
each is moved to the host with ``.cpu().numpy()`` (a bf16 tensor as its
raw 2-byte words, which is how numpy stores the reference's bf16), so a
checkpoint written by either package restores in the other. Writes are
crash-safe: everything lands in a tmp dir that is atomically renamed;
:func:`restore` and ``serving/persist.load_snapshot`` verify the hashes.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.tree import flatten_with_path, leaves, unflatten


def _leaf_paths(tree) -> list:
    return [("/".join(path), leaf) for path, leaf in flatten_with_path(tree)]


def _host(leaf) -> np.ndarray:
    """A leaf on the host; a DTensor is gathered whole first (a
    collective: every rank of its mesh calls it)."""
    if hasattr(leaf, "full_tensor"):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.asarray(leaf)


def _like(arr: np.ndarray, leaf, device=None):
    """``arr`` as ``leaf`` holds it: a tensor of its dtype on ``device``
    (default its device), else a numpy array (a tensor on ``device``
    when one is given)."""
    if not isinstance(leaf, torch.Tensor):
        return arr if device is None else torch.from_numpy(arr).to(device)
    if leaf.dtype == torch.bfloat16:
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=leaf.device if device is None else device,
                dtype=leaf.dtype)


def _hash(arr: np.ndarray) -> str:
    """blake2s of ``arr``'s C-order bytes (``arr.tobytes()``'s), read in
    place when ``arr`` is contiguous rather than copied first."""
    flat = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    return hashlib.blake2s(flat, digest_size=16).hexdigest()


def save(ckpt_dir: str | Path, step: int, tree: Any,
         extra: Optional[dict] = None) -> Path:
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    manifest = {"step": step, "leaves": {}, "extra": extra or {}}
    for name, leaf in _leaf_paths(tree):
        arr = _host(leaf)
        fname = name.replace("/", "__") + ".npy"
        np.save(tmp / fname, arr)
        manifest["leaves"][name] = {
            "file": fname, "shape": list(arr.shape),
            "dtype": str(arr.dtype), "hash": _hash(arr)}
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)          # atomic publish
    return final


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in ckpt_dir.iterdir()
             if p.name.startswith("step_")]
    return max(steps) if steps else None


def restore(ckpt_dir: str | Path, step: int, like: Any,
            shardings: Any = None, verify: bool = True) -> Any:
    """Restore step ``step`` into the structure of ``like`` (nested dicts
    and lists of tensors or arrays): each leaf, found by its name, comes
    back with ``like``'s leaf's dtype, placed by the matching leaf of
    ``shardings`` (a tree shaped as ``like``) or, without it, on
    ``like``'s leaf's device. A ``shardings`` leaf is a ``torch.device``
    (or its name), or a ``sharding.NamedSharding``: a spec on a
    ``DeviceMesh``, the leaf coming back as a DTensor placed by it (its
    shard on the mesh's device: the reference's restore onto
    NamedShardings, so a checkpoint written from one mesh shape restores
    onto another: the elastic reshard). A leaf whose bytes do not match
    the manifest's hash raises ``IOError`` naming it."""
    from repro_torch.distributed.sharding import NamedSharding, distribute
    src = Path(ckpt_dir) / f"step_{step:08d}"
    metas = json.loads((src / "manifest.json").read_text())["leaves"]
    paths = _leaf_paths(like)
    places = [None] * len(paths) if shardings is None else \
        [d if isinstance(d, NamedSharding) else torch.device(d)
         for d in leaves(shardings)]
    if len(places) != len(paths):
        raise ValueError(f"shardings has {len(places)} leaves, like "
                         f"{len(paths)}")
    out = []
    for (name, leaf), place in zip(paths, places):
        meta = metas[name]
        arr = np.load(src / meta["file"])
        if verify and _hash(arr) != meta["hash"]:
            raise IOError(f"checkpoint corruption in leaf {name}")
        if isinstance(place, NamedSharding):
            dev = "cpu" if place.mesh.device_type == "cpu" else \
                torch.device("cuda", torch.cuda.current_device())
            out.append(distribute(_like(arr, _plain(leaf), dev), place))
        else:
            out.append(_like(arr, _plain(leaf), place))
    return unflatten(like, out)


def _plain(leaf):
    """``leaf``'s local shard when it is a DTensor (its dtype is the
    leaf's), else ``leaf``."""
    return leaf.to_local() if hasattr(leaf, "to_local") else leaf


def prune(ckpt_dir: str | Path, keep: int = 3):
    ckpt_dir = Path(ckpt_dir)
    steps = sorted(int(p.name.split("_")[1]) for p in ckpt_dir.iterdir()
                   if p.name.startswith("step_"))
    for s in steps[:-keep]:
        shutil.rmtree(ckpt_dir / f"step_{s:08d}", ignore_errors=True)
