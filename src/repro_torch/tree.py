"""Nested dicts (and lists) of tensors read as the JAX package's pytrees:
leaves in ``jax.tree_util`` order (dict keys sorted), each with its key
path, joined by "/" as the JAX package's checkpoints name it.  As in JAX, a
subclass of tuple (a spec ``P``) is a leaf."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _items(tree):
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if type(tree) in (list, tuple):
        return list(enumerate(tree))
    return None


def flatten_with_paths(tree) -> List[Tuple[Tuple, Any]]:
    """[(key path, leaf)] in ``jax.tree_util.tree_flatten_with_path`` order."""
    items = _items(tree)
    if items is None:
        return [((), tree)]
    return [((k,) + path, leaf) for k, sub in items
            for path, leaf in flatten_with_paths(sub)]


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def key_paths(tree) -> List[str]:
    """Each leaf's key path as the JAX package's checkpoints write it."""
    return ["/".join(str(k) for k in path) for path, _ in flatten_with_paths(tree)]


def _build(t, it):
    items = _items(t)
    if items is None:
        return next(it)
    if isinstance(t, dict):
        return {k: _build(sub, it) for k, sub in items}
    return type(t)(_build(sub, it) for _, sub in items)


def unflatten(like, new_leaves) -> Any:
    """A tree of ``like``'s structure holding ``new_leaves`` in leaf order.
    (No nested recursive closure: one would be a reference cycle holding
    ``new_leaves`` until the garbage collector runs, GiBs of a train step's
    gradients and copies on the card.)"""
    return _build(like, iter(new_leaves))


def tree_map(fn: Callable, tree, *rest) -> Any:
    return unflatten(tree, [fn(*ls) for ls in
                            zip(leaves(tree), *(leaves(r) for r in rest))])
