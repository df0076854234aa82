"""Plain-dict parameter trees: the port's stand-in for ``jax.tree_util``.

A tree is nested dicts, tuples and lists with tensors at the leaves (the
``{"enc", "dec", "out"}`` parameter tree and everything shaped like it:
gradients, optimizer moments). Leaves are visited with dict keys in sorted
order, as ``jax.tree_util.tree_leaves`` does.
"""

from __future__ import annotations

from typing import Any, Callable, List


def tree_leaves(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    if isinstance(tree, (tuple, list)):
        return [leaf for node in tree for leaf in tree_leaves(node)]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf over trees of one structure."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, tree[key], *(r[key] for r in rest))
                for key in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, node, *(r[i] for r in rest))
                          for i, node in enumerate(tree))
    return fn(tree, *rest)


def tree_unflatten(like: Any, leaves: List[Any]) -> Any:
    """The tree shaped like `like` whose leaves, in :func:`tree_leaves`
    order, are `leaves`."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {key: build(node[key]) for key in sorted(node)}
        if isinstance(node, (tuple, list)):
            return type(node)(build(n) for n in node)
        return next(it)

    return build(like)
