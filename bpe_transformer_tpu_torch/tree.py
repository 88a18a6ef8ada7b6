"""Nested dicts, lists and tuples of tensors (the parameter tree): the
counterparts of ``jax.tree_util.tree_leaves`` / ``tree_map`` that the port
needs.  Dict leaves are visited in sorted key order, as JAX flattens them."""

from __future__ import annotations


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in a fixed order."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in tree_leaves(item)]
    return [tree]


def tree_flatten_with_path(tree, prefix: tuple = ()) -> list[tuple[tuple, object]]:
    """``(path, leaf)`` pairs in :func:`tree_leaves` order; ``path`` is the
    tuple of dict keys and list indices from the root (the counterpart of
    ``jax.tree_util.tree_flatten_with_path``)."""
    if isinstance(tree, dict):
        return [pair for key in sorted(tree)
                for pair in tree_flatten_with_path(tree[key], prefix + (key,))]
    if isinstance(tree, (list, tuple)):
        return [pair for i, item in enumerate(tree)
                for pair in tree_flatten_with_path(item, prefix + (i,))]
    return [(prefix, tree)]


def path_str(path: tuple) -> str:
    """A key path as a dotted tensor path (``layers.3.attn.q_proj``)."""
    return ".".join(str(part) for part in path)


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf across trees of one structure."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, tree[key], *(r[key] for r in rest)) for key in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *items) for items in zip(tree, *rest))
    return fn(tree, *rest)


def tree_unflatten(tree, leaves):
    """A tree of ``tree``'s structure holding ``leaves`` (in
    :func:`tree_leaves` order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            built = {key: build(node[key]) for key in sorted(node)}
            return {key: built[key] for key in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(item) for item in node)
        return next(it)

    return build(tree)
