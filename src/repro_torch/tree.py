"""Nested containers of tensors ("trees"), walked as ``jax.tree_util``
walks the JAX package's pytrees.

A tree is a dict (items in sorted key order), a NamedTuple (fields in
order), a list or tuple (items in order), or a leaf: anything else.
``None`` and empty containers hold no leaf.  The optimizers, the
checkpointer and the train steps use these walks, so a tree's leaves come
in the JAX package's order and a checkpoint names them by JAX's paths.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

Path = Tuple[Any, ...]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree):
    """(part, child) pairs of a container, or None for a leaf.  A part is
    a dict key, a NamedTuple field's name, or a sequence index (int)."""
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    if tree is None:
        return []
    return None


def _rebuild(tree, children: List[Any]):
    """A container of ``tree``'s kind holding ``children`` in walk order."""
    if isinstance(tree, dict):
        return dict(zip(sorted(tree), children))
    if _is_namedtuple(tree):
        return type(tree)(*children)
    if isinstance(tree, (list, tuple)):
        return type(tree)(children)
    return None


def flatten_with_path(tree, prefix: Path = ()) -> Iterator[Tuple[Path,
                                                                 Any]]:
    """Every leaf with the parts of its path, in walk order."""
    children = _children(tree)
    if children is None:
        yield prefix, tree
        return
    for part, child in children:
        yield from flatten_with_path(child, prefix + (part,))


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in flatten_with_path(tree)]


def unflatten(like, new_leaves) -> Any:
    """``like``'s structure with its leaves replaced, in walk order."""
    it = iter(new_leaves)

    def build(node):
        children = _children(node)
        if children is None:
            return next(it)
        return _rebuild(node, [build(c) for _, c in children])
    out = build(like)
    if next(it, it) is not it:
        raise ValueError("more leaves than the structure holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and of trees of the same
    structure, leaf by leaf."""
    first, others = leaves(tree), [leaves(r) for r in rest]
    if any(len(o) != len(first) for o in others):
        raise ValueError("the trees hold different numbers of leaves")
    return unflatten(tree, [fn(leaf, *(o[i] for o in others))
                            for i, leaf in enumerate(first)])
