"""Nested containers of tensors (the port's parameter and state trees).

The reference walks its pytrees with ``jax.tree_util``; the port's trees are
dicts (sorted by key, as ``jax.tree_util`` orders them), lists, tuples and
NamedTuples of tensors, and these helpers walk them in that fixed order.
A leaf is anything else (a tensor, a number, None).
"""
from __future__ import annotations


def _children(node):
    """[(key, child)] of a container in a fixed order, or None for a leaf."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f, getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def _rebuild(node, children):
    if isinstance(node, dict):
        return dict(zip(sorted(node), children))
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*children)
    return type(node)(children)


def flatten_with_path(tree, prefix=()):
    """[(path tuple, leaf)] in the tree's fixed order."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for k, child in kids:
        out.extend(flatten_with_path(child, prefix + (k,)))
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def unflatten(like, new_leaves):
    """A tree of ``like``'s structure holding ``new_leaves`` in order."""
    it = iter(new_leaves)

    def build(node):
        kids = _children(node)
        if kids is None:
            return next(it)
        return _rebuild(node, [build(c) for _, c in kids])

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def map_tree(fn, tree, *rest):
    """fn over the leaves of ``tree`` and the same-shaped ``rest``."""
    others = [leaves(r) for r in rest]
    return unflatten(tree, [fn(*xs) for xs in zip(leaves(tree), *others,
                                                  strict=True)])
