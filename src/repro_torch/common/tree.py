"""Tree helpers over the port's parameter trees (nested dicts and lists
of tensors; port of ``src/repro/common/tree.py``).

``tree_map`` walks several trees of one structure at once, as
``jax.tree.map`` does; the stacking helpers put clients on a leading
axis and take them off again.
"""
from __future__ import annotations

import torch


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leafwise over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves in a stable order (dict insertion order, list order)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree, leaves):
    """A tree of ``tree``'s structure holding ``leaves`` (in
    ``tree_leaves`` order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def tree_stack(trees):
    """Stack a list of identical trees along a new leading axis."""
    return tree_map(lambda *xs: torch.stack(xs, dim=0), *trees)


def tree_unstack(tree, n: int):
    """Inverse of tree_stack: a stacked tree -> list of n trees."""
    return [tree_index(tree, i) for i in range(n)]


def tree_index(tree, i):
    """Index into the leading (stacked) axis of every leaf."""
    return tree_map(lambda x: x[i], tree)
