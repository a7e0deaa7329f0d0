"""Nested containers of tensors, walked the way ``jax.tree_util`` walks them.

The port keeps the reference's trees (dicts, NamedTuples such as
``optim.OptState``, lists and tuples, with tensors at the leaves) and needs
three of ``jax.tree_util``'s services without JAX: the leaf order (dict
keys sorted at every level, NamedTuple fields and sequence items in
order, ``None`` an empty subtree), the path strings of
``jax.tree_util.keystr`` (``['key']`` for a dict key, ``.field`` for a
NamedTuple field, ``[i]`` for a sequence item) and a structure-preserving
map.  ``repro_torch.checkpoint`` keys its manifest by these paths, so a
checkpoint written by either package restores in the other.
"""

from __future__ import annotations

from typing import Any, Callable

__all__ = ["leaves", "leaves_with_path", "tree_map", "tree_map_with_path", "unflatten_like"]


def _children(node) -> list | None:
    """(path piece, child) of a container node; None for a leaf."""
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(node)]
    if node is None:
        return []
    return None


def _rebuild(node, children: list):
    if isinstance(node, dict):
        return dict(zip(sorted(node), children))
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*children)
    if isinstance(node, list):
        return list(children)
    if isinstance(node, tuple):
        return tuple(children)
    return None


def leaves_with_path(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """(keystr path, leaf) of every leaf, in ``jax.tree_util``'s order."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    return [x for piece, child in kids for x in leaves_with_path(child, prefix + piece)]


def leaves(tree) -> list:
    """Every leaf, in ``jax.tree_util``'s order."""
    return [leaf for _, leaf in leaves_with_path(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf to ``tree`` and trees of its structure
    (their leaves passed as further arguments); containers rebuilt."""
    kids = _children(tree)
    if kids is None:
        return fn(tree, *rest)
    others = [_children(r) for r in rest]
    if any(o is None or len(o) != len(kids) for o in others):
        raise ValueError("tree_map: trees differ in structure")
    return _rebuild(tree, [tree_map(fn, child, *(o[i][1] for o in others))
                           for i, (_, child) in enumerate(kids)])


def tree_map_with_path(fn: Callable, tree, *rest):
    """``fn(keystr path, leaf, *leaves of rest)`` over ``tree``, as
    ``jax.tree_util.tree_map_with_path`` maps; containers rebuilt."""
    paths = iter([path for path, _ in leaves_with_path(tree)])
    return tree_map(lambda *xs: fn(next(paths), *xs), tree, *rest)


def unflatten_like(like, flat: list):
    """The leaves ``flat`` (in leaf order) in the structure of ``like``."""
    it = iter(flat)
    return tree_map(lambda _: next(it), like)
