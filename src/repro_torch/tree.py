"""Nested dicts and lists of arrays, the shape of the reference's pytrees,
and their flat views keyed by path.

The reference keeps parameters and optimizer states as pytrees of nested
dicts (and lists: the recommenders' MLPs) and flattens them in sorted key
order (``jax.tree_util``). The port
keeps the same trees where they cross to the reference (checkpoints, the
tests) and works on flat ``{path: tensor}`` dicts, a path being the tuple of
keys from the root, in the same sorted order.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator

Path = tuple


def leaves(tree: Any, prefix: Path = ()) -> Iterator[tuple[Path, Any]]:
    """(path, leaf) of a tree of dicts, lists and tuples, in jax's order:
    a dict's keys sorted, a sequence's items by index."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, prefix + (i,))
    else:
        yield prefix, tree


def flatten(tree: Any) -> dict:
    """A nested tree -> ``{path: leaf}`` in jax's order."""
    return dict(leaves(tree))


def nest(flat: dict) -> Any:
    """``{path: leaf}`` -> the nested tree, the inverse of :func:`flatten`:
    a node whose keys are exactly the ints 0..n-1 becomes a list (the
    reference's MLPs and cross layers are lists), any other a dict."""
    out: dict = {}
    for path, v in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return _lists(out)


def _lists(node: Any) -> Any:
    if not isinstance(node, dict):
        return node
    kids = {k: _lists(v) for k, v in node.items()}
    if kids and all(type(k) is int for k in kids) and \
            set(kids) == set(range(len(kids))):
        return [kids[i] for i in range(len(kids))]
    return kids


def get(tree: dict, path: Path) -> Any:
    """The subtree of ``tree`` at ``path``."""
    for k in path:
        tree = tree[k]
    return tree


def map_leaves(fn: Callable, *trees: dict) -> dict:
    """``fn`` over the leaves of flat dicts with the same keys, in the first
    one's order."""
    return {k: fn(*(t[k] for t in trees)) for k in trees[0]}
