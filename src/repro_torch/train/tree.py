"""Nested parameter and state trees: the few ``jax.tree`` operations the
training substrate needs, in the reference's leaf order.

A tree is a dict (keys visited in sorted order, as ``jax.tree_util`` does),
a list or tuple (in order), a NamedTuple or dataclass (fields in order,
keyed by name), ``None`` (no leaves) or a leaf (anything else).  A leaf's
path is the tuple of its keys as strings: dict keys, list indices, field
names, so ``"/".join(path)`` is the reference checkpoint's key
(``train/checkpoint.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, List, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield str(k), tree[k]
    elif _is_namedtuple(tree):
        yield from zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield str(i), v
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield f.name, getattr(tree, f.name)


def _is_node(tree) -> bool:
    return (isinstance(tree, (dict, list, tuple))
            or (dataclasses.is_dataclass(tree)
                and not isinstance(tree, type)))


def leaves_with_paths(tree, prefix: Tuple[str, ...] = ()
                      ) -> List[Tuple[Tuple[str, ...], Any]]:
    """``[(path, leaf), ...]`` in the reference's flattening order."""
    if tree is None:
        return []
    if not _is_node(tree):
        return [(prefix, tree)]
    out = []
    for key, child in _children(tree):
        out.extend(leaves_with_paths(child, prefix + (key,)))
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def _rebuild(tree, new_children: dict):
    if isinstance(tree, dict):
        return {k: new_children[str(k)] for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(new_children[f] for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(new_children[str(i)] for i in range(len(tree)))
    return dataclasses.replace(tree, **new_children)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); ``None`` stays ``None``."""
    if tree is None:
        return None
    if not _is_node(tree):
        return fn(tree, *rest)
    rest_children = [dict(_children(r)) for r in rest]
    return _rebuild(tree, {
        key: tree_map(fn, child, *(rc[key] for rc in rest_children))
        for key, child in _children(tree)})


def unflatten_like(tree, new_leaves):
    """``tree``'s structure with ``new_leaves`` (in flattening order)."""
    it = iter(new_leaves)
    out = tree_map(lambda _: next(it), tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
