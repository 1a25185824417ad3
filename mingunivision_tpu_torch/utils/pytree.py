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


def is_float_tree(tree) -> bool:
    """Whether every leaf is a plain tensor (no QuantizedArray): the trees
    `layer_views` takes."""
    if isinstance(tree, dict):
        return all(is_float_tree(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return all(is_float_tree(v) for v in tree)
    return not isinstance(tree, QuantizedArray)


def layer_view(tree, i: int):
    """Layer i of a depth-stacked tree: zero-copy views of every leaf (q[i] and
    s[i] of a quantized one)."""
    return tree_map(lambda t: t[i], tree)


def layer_views(tree, depth: int):
    """[layer 0, ..., layer depth-1] of a depth-stacked float tree, each leaf
    split by one `unbind` (under autograd its backward is one stack, where
    indexing a leaf once per layer gives one full-size zero gradient per
    layer)."""
    if isinstance(tree, dict):
        per_key = {k: layer_views(v, depth) for k, v in tree.items()}
        return [{k: per_key[k][i] for k in tree} for i in range(depth)]
    if isinstance(tree, (list, tuple)):
        parts = [layer_views(v, depth) for v in tree]
        return [type(tree)(p[i] for p in parts) for i in range(depth)]
    return list(tree.unbind(0))
