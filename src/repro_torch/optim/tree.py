"""Nested containers of tensors ("trees"), the port's stand-in for JAX's
pytrees: dicts (walked in sorted key order, as ``jax.tree`` walks them),
lists and tuples, with tensors, arrays or scalars as leaves."""
from __future__ import annotations

__all__ = ["tree_leaves", "tree_map", "tree_items"]


def tree_items(tree, prefix=()):
    """``(path, leaf)`` pairs in JAX's flattening order; a path is the
    tuple of dict keys and sequence indices leading to the leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_items(v, prefix + (i,))
    else:
        yield prefix, tree


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_items(tree)]


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)
