"""Leaf walks over the training path's trees of tensors.

The reference's parameters, optimizer state and checkpoints are JAX pytrees;
the port's are plain nests of dicts, lists, tuples and NamedTuples
(``AdamWState``, ``CompressionState``) with tensors at the leaves (or, on a
mesh, ``util.sharded.Sharded`` pieces).  The walk
order is fixed, as ``jax.tree`` fixes it: dict entries in sorted key order,
sequence entries in order; ``None`` is an empty subtree.  The optimizer pairs
the leaves of params, gradients and moments by this order, and a checkpoint
stores leaf i at this position.
"""
from __future__ import annotations

from typing import Any, Callable, List


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _is_node(x) -> bool:
    """A list, a tuple or a NamedTuple; another subclass of tuple (a
    ``PartitionSpec``, a ``torch.Size``) is a leaf, as in ``jax.tree``."""
    return type(x) in (list, tuple) or _is_namedtuple(x)


def leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in walk order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if _is_node(tree):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def leaf_paths(tree, prefix: tuple = ()) -> List[tuple]:
    """The key path (dict keys and sequence positions) of each leaf of
    ``tree``, in walk order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [q for k in sorted(tree) for q in leaf_paths(tree[k], prefix + (k,))]
    if _is_node(tree):
        return [q for i, v in enumerate(tree) for q in leaf_paths(v, prefix + (i,))]
    return [prefix]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf to ``tree`` and the trees in ``rest`` (of
    the same structure), in walk order; the structure of ``tree`` is kept
    (dict key order, list, tuple and NamedTuple types)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        out = {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if _is_node(tree):
        vals = [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        if _is_namedtuple(tree):
            return type(tree)(*vals)
        return type(tree)(vals)
    return fn(tree, *rest)


def structure(tree) -> str:
    """A text form of the tree's structure, leaves as ``*`` (for manifests)."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {structure(tree[k])}" for k in sorted(tree)) + "}"
    if _is_node(tree):
        inner = ", ".join(structure(v) for v in tree)
        if _is_namedtuple(tree):
            return f"{type(tree).__name__}({inner})"
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    return "*"
