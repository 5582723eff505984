"""Small helpers over nested dicts of tensors (the port's parameter and
cache trees), port of :mod:`repro.utils.pytrees`."""
from __future__ import annotations


def flatten_with_paths(tree, prefix: str = ""):
    """(path, leaf) pairs with '/'-joined dict keys, keys sorted at every
    level (the order jax.tree_util flattens dicts in)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(flatten_with_paths(tree[k], f"{prefix}{k}/"))
        return out
    return [(prefix[:-1], tree)]


def unflatten_paths(pairs) -> dict:
    """Inverse of flatten_with_paths for dict-only trees."""
    root: dict = {}
    for path, leaf in pairs:
        node = root
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return root

