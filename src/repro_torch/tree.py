"""Nested containers of tensors: the port's stand-in for ``jax.tree_util``.

Params, LC states and Θs are trees of dicts, tuples (NamedTuples
included) and lists with tensors or other values at the leaves.
"""
from __future__ import annotations

from typing import Any, Callable


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leafwise over trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree) -> list[Any]:
    """Leaves in tree order (dict keys in insertion order)."""
    out: list = []
    tree_map(out.append, tree)
    return out
