"""Nested dicts, lists and tuples of tensors ("trees"), walked as
``jax.tree_util`` walks them: dict keys in sorted order, sequence items in
order, ``None`` an empty subtree.  The order decides the leaf keys of a
checkpoint and the order of the optimizer's global-norm sum, so both match
the reference's."""
from __future__ import annotations

from typing import Any, Callable, Optional


def _children(node) -> Optional[list]:
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def _walk(node, path: tuple, is_leaf: Optional[Callable], out: list) -> None:
    if node is None:
        return
    kids = None if is_leaf is not None and is_leaf(node) else _children(node)
    if kids is None:
        out.append((path, node))
        return
    for key, child in kids:
        _walk(child, path + (key,), is_leaf, out)


def tree_flatten_with_path(tree, is_leaf: Optional[Callable] = None
                           ) -> list[tuple[tuple, Any]]:
    """[(path, leaf)] in the reference's order; a path is the tuple of dict
    keys and sequence indices from the root.  (A module-level walk: a nested
    one that calls itself through its closure makes a reference cycle,
    which would keep the returned leaves alive until the cycle collector
    runs, gigabytes of gradients in a train step.)"""
    out: list = []
    _walk(tree, (), is_leaf, out)
    return out


def tree_leaves(tree, is_leaf: Optional[Callable] = None) -> list:
    return [leaf for _, leaf in tree_flatten_with_path(tree, is_leaf)]


def key_str(path: tuple) -> str:
    """The '/'-joined key of a leaf path (the checkpoint's leaf key)."""
    return "/".join(str(p) for p in path)


def tree_map_with_path(fn: Callable, tree,
                       is_leaf: Optional[Callable] = None, _path=()):
    """``fn(path, leaf)`` over the leaves, in a tree of the same structure."""
    if tree is None:
        return None
    if is_leaf is None or not is_leaf(tree):
        if isinstance(tree, dict):
            return {k: tree_map_with_path(fn, v, is_leaf, _path + (k,))
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(tree_map_with_path(fn, v, is_leaf, _path + (i,))
                              for i, v in enumerate(tree))
    return fn(_path, tree)


def tree_map(fn: Callable, tree, *rest, is_leaf: Optional[Callable] = None):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure), in a tree of that structure."""
    if tree is None:
        return None
    if is_leaf is None or not is_leaf(tree):
        if isinstance(tree, dict):
            return {k: tree_map(fn, tree[k], *(r[k] for r in rest),
                                is_leaf=is_leaf) for k in tree}
        if isinstance(tree, (list, tuple)):
            return type(tree)(tree_map(fn, t, *(r[i] for r in rest),
                                       is_leaf=is_leaf)
                              for i, t in enumerate(tree))
    return fn(tree, *rest)
