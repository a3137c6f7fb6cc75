"""Nested-dict trees of tensors: the model zoo's parameters, gradients
and optimizer moments.

Two trees match when they have the same keys at every level; key order
may differ (the reference's ``tree_map`` sorts keys, its ``init`` does
not), so every function here walks the first tree's keys and looks the
others up by key.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` of each leaf of ``tree`` and the matching leaves of
    ``rest``, in ``tree``'s nesting."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves in ``tree``'s key order."""
    out: List[Any] = []

    def walk(node):
        if isinstance(node, dict):
            for v in node.values():
                walk(v)
        else:
            out.append(node)

    walk(tree)
    return out


def tree_unflatten(template: Any, leaves: Iterator[Any]) -> Any:
    """``template``'s nesting with its leaves taken from ``leaves`` in
    :func:`tree_leaves`' order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)
