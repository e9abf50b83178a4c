"""Nested-container helpers for the training state: the counterpart of the
``jax.tree`` calls the reference's optimizer, checkpoint store and trainer
make.

A tree is a dict, list or tuple of subtrees, or a leaf (a tensor, an
array, a number).  Dicts are walked in sorted key order and ``None`` holds
no leaf, as in ``jax.tree_util``, so leaves come out in the reference's
order and key paths read the same (`flatten_with_paths`).
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def flatten_with_paths(tree, prefix: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """``[(key path, leaf)]`` in the reference's leaf order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in flatten_with_paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in flatten_with_paths(v, prefix + (i,))]
    return [(prefix, tree)]


def at_path(tree, path: Tuple) -> Any:
    """The subtree of ``tree`` at the key path ``path``."""
    for key in path:
        tree = tree[key]
    return tree


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def unflatten(like, values) -> Any:
    """A tree of ``like``'s structure holding ``values`` (in its leaf
    order)."""
    it = iter(values)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}        # keep the caller's order
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)
    return build(like)


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree in ``rest`` (same structure)."""
    others = [leaves(r) for r in rest]
    return unflatten(tree, [fn(x, *(o[i] for o in others))
                            for i, x in enumerate(leaves(tree))])
