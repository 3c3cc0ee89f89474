"""Trees of tensors: the parameter, gradient, optimizer-state and
checkpoint trees.

A tree is a dict, a list, a tuple or a NamedTuple of trees, and every other
node is a leaf, as is a tuple whose class sets ``tree_leaf`` (a partition
spec, ``distributed.partition.PartitionSpec``). Leaves come in the order of
the tree (a dict's insertion order, not the reference's sorted keys), and
each leaf's path is the dict keys, list or tuple indices and NamedTuple
field names that lead to it. This stands in for ``jax.tree`` in the port's
optimizers, train step, checkpoint manager and partition specs.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Tuple

Path = Tuple[Any, ...]


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node):
    """(key, child) pairs of an inner node, or None for a leaf."""
    if getattr(node, "tree_leaf", False):
        return None
    if isinstance(node, dict):
        return list(node.items())
    if _is_namedtuple(node):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def leaves_with_path(tree, path: Path = ()) -> Iterator[Tuple[Path, Any]]:
    """(path, leaf) for every leaf of ``tree``, in order."""
    children = _children(tree)
    if children is None:
        yield path, tree
        return
    for key, child in children:
        yield from leaves_with_path(child, path + (key,))


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in leaves_with_path(tree)]


def unflatten(like, values) -> Any:
    """A tree shaped like ``like`` whose leaves are ``values``, in order."""
    it = iter(values)

    def build(node):
        children = _children(node)
        if children is None:
            return next(it)
        if isinstance(node, dict):
            return {k: build(c) for k, c in children}
        built = [build(c) for _, c in children]
        if _is_namedtuple(node):
            return type(node)(*built)
        return type(node)(built)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more values than the tree has leaves")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree in ``rest`` (same structure), as a tree like ``tree``."""
    flat = [leaves(t) for t in (tree,) + rest]
    if any(len(f) != len(flat[0]) for f in flat):
        raise ValueError("trees differ in their number of leaves")
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)])


def stacks(tree) -> List[Tuple[List[int], bool]]:
    """The leaves grouped as the reference stacks them: leaves whose paths
    differ only in list indices (the same parameter at every depth of
    ``layers``) are one leaf of the reference with a leading depth axis.
    Returns (leaf positions, stacked) a group, in the order of each group's
    first leaf; a leaf under no list is a group of its own, not stacked."""
    groups: Dict[Path, List[int]] = {}
    for i, (path, _) in enumerate(leaves_with_path(tree)):
        key = tuple("*" if isinstance(k, int) else k for k in path)
        groups.setdefault(key, []).append(i)
    return [(pos, "*" in key) for key, pos in groups.items()]
