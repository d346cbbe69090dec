"""Nested containers of tensors (the port's counterpart of ``jax.tree``).

A tree is a dict, a tuple (a NamedTuple included) or a list of trees, or a
leaf; ``None`` is an empty subtree, as in JAX. Dicts are visited in sorted
key order, as ``jax.tree.flatten`` visits them, so leaf order and leaf
paths (``"m/layers/attn/wq"``) are the reference's: the checkpoint format
and the training step's leaf-by-leaf sums rely on both."""

from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _children(tree) -> List[Tuple[str, Any]]:
    """(path key, child) pairs of a container, or ``[]`` for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (tuple, list)):
        return [(str(i), c) for i, c in enumerate(tree)]
    return []


def _is_leaf(tree) -> bool:
    return not isinstance(tree, (dict, tuple, list)) and tree is not None


def flatten_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in JAX's order; path keys joined by ``/``."""
    if tree is None:
        return []
    if _is_leaf(tree):
        return [(prefix, tree)]
    out = []
    for key, child in _children(tree):
        out += flatten_with_paths(child, f"{prefix}/{key}" if prefix else key)
    return out


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf to ``tree`` and the trees in ``rest``
    (each of ``tree``'s structure); the result has ``tree``'s structure."""
    if tree is None:
        return None
    if _is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    kids = [tree_map(fn, c, *(r[i] for r in rest))
            for i, c in enumerate(tree)]
    if hasattr(tree, "_fields"):
        return type(tree)(*kids)
    return type(tree)(kids)


def unflatten_like(tree, flat: List[Any]):
    """A tree of ``tree``'s structure whose leaves are ``flat``, in order."""
    it = iter(flat)
    out = tree_map(lambda _: next(it), tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
