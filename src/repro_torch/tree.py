"""Nested-container helpers for the port's parameter and optimizer trees.

The port keeps its trees as plain nested ``dict``s and ``tuple``s (or
``list``s) of tensors, the structure the JAX package keeps as pytrees.
These helpers walk them in ``jax.tree_util``'s order (a dict's keys
sorted, a plain tuple or list in order; anything else, a named tuple
among them, is a leaf), so a leaf's index and its path are the
ones the JAX package gives the same leaf: the checkpoint layout and the
order of every sum over leaves (``optim.global_norm``) follow from it.
A path is the JAX package's checkpoint key, the dict keys and sequence
indices joined by ``/`` (``params/pat/0/wq``).
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _children(tree):
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if type(tree) in (tuple, list):
        return list(enumerate(tree))
    return None


def flatten_with_path(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """Every leaf with its path, in ``jax.tree_util`` order."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for k, v in kids:
        out += flatten_with_path(v, f"{prefix}/{k}" if prefix else str(k))
    return out


def leaves(tree) -> list:
    """Every leaf, in ``jax.tree_util`` order."""
    return [leaf for _, leaf in flatten_with_path(tree)]


def unflatten(like, flat):
    """A tree of ``like``'s structure holding ``flat``'s leaves in order."""
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}      # the caller's key order
        if type(t) in (tuple, list):
            return type(t)(build(v) for v in t)
        return next(it)
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree in ``rest`` (same structure, or deeper below a leaf of
    ``tree``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if type(tree) in (tuple, list):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)
