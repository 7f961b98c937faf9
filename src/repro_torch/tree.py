"""Nested dicts of tensors as pytrees: the few ``jax.tree`` operations the
port needs.  Leaves are visited in sorted-key order, the order
``jax.tree.flatten`` gives a dict, so a flattened vector lines up element
for element with the JAX package's."""
from __future__ import annotations

from typing import Callable, List


def tree_leaves(tree) -> List:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of each tree in ``rest`` (the
    same structure); anything but a dict is a leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_unflatten(like, leaves: List):
    """A tree shaped like ``like`` with ``leaves`` in sorted-key order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
