"""Nested dicts and lists of tensors, walked in the reference's order.

The JAX package walks its parameter and optimizer trees with
``jax.tree_util``: dict keys sorted, list and tuple items in order. The
port's trees are the same nested dicts and lists, and these helpers walk
them in that order, so a leaf has the same name and the same place in a
flat list in both packages (checkpoint leaf names, the optimizer's
global norm).
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def flatten_with_path(tree, prefix: Tuple[str, ...] = ()) -> list:
    """(path, leaf) pairs, a path being the keys and list positions from
    the root as strings (``("mlp", "0", "w")``)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += flatten_with_path(tree[k], prefix + (str(k),))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, t in enumerate(tree):
            out += flatten_with_path(t, prefix + (str(i),))
        return out
    return [(prefix, tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def unflatten(like, new_leaves: List[Any]):
    """A tree of ``like``'s structure holding ``new_leaves`` in the order
    :func:`leaves` lists ``like``'s."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)
    out = build(like)
    if any(True for _ in it):
        raise ValueError("more leaves than the tree has")
    return out


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *rs)
                          for t, *rs in zip(tree, *rest))
    return fn(tree, *rest)
