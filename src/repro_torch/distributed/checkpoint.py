"""Checkpoint save with integrity manifests (port of
``repro/distributed/checkpoint.py``).

Layout: <dir>/step_<N>/
    manifest.json        {paths, shapes, dtypes, blake2s hashes, step}
    <leaf-path>.npy      one file per leaf

A tree is nested dicts whose leaves are tensors or numpy arrays. Leaves
are named and ordered as the reference names them
(``jax.tree_util.tree_flatten_with_path``: dict keys sorted, joined by
``/``), and each is moved to the host with ``.cpu().numpy()``, so a
checkpoint written by either package reads in the other. Writes are crash-safe: everything lands in a tmp dir that is
atomically renamed; readers (``serving/persist.load_snapshot``) verify
the hashes.
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


def _flatten(tree, prefix=()):
    """(path tuple, leaf) pairs in the reference's leaf order."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out += _flatten(tree[k], prefix + (str(k),))
    return out


def _leaf_paths(tree) -> list:
    return [("/".join(path), leaf) for path, leaf in _flatten(tree)]


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _hash(arr: np.ndarray) -> str:
    return hashlib.blake2s(arr.tobytes(), digest_size=16).hexdigest()


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


def prune(ckpt_dir: str | Path, keep: int = 3):
    ckpt_dir = Path(ckpt_dir)
    steps = sorted(int(p.name.split("_")[1]) for p in ckpt_dir.iterdir()
                   if p.name.startswith("step_"))
    for s in steps[:-keep]:
        shutil.rmtree(ckpt_dir / f"step_{s:08d}", ignore_errors=True)
