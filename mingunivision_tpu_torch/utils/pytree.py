"""Helpers over parameter trees (nested dicts and lists of tensors)."""

from __future__ import annotations


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from leaves(v)
    else:
        yield tree


def layer_view(tree, i: int):
    """Layer i of a depth-stacked tree: zero-copy views of every leaf."""
    return tree_map(lambda t: t[i], tree)
