"""Helpers over parameter trees (nested dicts and lists of tensors and
`QuantizedArray`s)."""

from __future__ import annotations

from mingunivision_tpu_torch.utils.quantize import QuantizedArray


def tree_map(fn, tree):
    """Apply `fn` to every leaf; a QuantizedArray is one leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def leaves(tree):
    """Every tensor of the tree; a QuantizedArray gives its `q` and `s`."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from leaves(v)
    elif isinstance(tree, QuantizedArray):
        yield tree.q
        yield tree.s
    else:
        yield tree


def layer_view(tree, i: int):
    """Layer i of a depth-stacked tree: zero-copy views of every leaf (q[i] and
    s[i] of a quantized one)."""
    return tree_map(lambda t: t[i], tree)
