"""Parameter and optimizer trees: nested dicts, lists, tuples and
NamedTuples with tensor leaves, walked in the reference's order.

JAX flattens a dict by its sorted keys, a list or tuple by position and
a NamedTuple by its fields in order, and drops ``None``.  A leaf's name
is its key path as ``jax.tree_util.keystr`` prints it, for example
``['params']['pattern'][0]['attn']['wq']`` or ``['opt_state'].mu['embed']``;
checkpoints name their files' leaves by it, so a checkpoint written by
either package restores in the other.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

PyTree = Any


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node) -> Iterator[Tuple[str, Any]]:
    """(key-path step, child) of a container, in the reference's order."""
    if isinstance(node, dict):
        for k in sorted(node):
            yield f"[{k!r}]", node[k]
    elif _is_namedtuple(node):
        for field, child in zip(node._fields, node):
            yield f".{field}", child
    else:
        for i, child in enumerate(node):
            yield f"[{i}]", child


def _is_container(node) -> bool:
    return isinstance(node, (dict, list, tuple))


def leaves_with_path(tree: PyTree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(key path, leaf) of every leaf that is not None, in order."""
    if tree is None:
        return []
    if not _is_container(tree):
        return [(prefix, tree)]
    out = []
    for step, child in _children(tree):
        out.extend(leaves_with_path(child, prefix + step))
    return out


def tree_leaves(tree: PyTree) -> List[Any]:
    return [leaf for _, leaf in leaves_with_path(tree)]


def tree_unflatten(like: PyTree, leaves: List[Any]) -> PyTree:
    """A tree of ``like``'s structure whose leaves, in order, are
    ``leaves`` (a None of ``like`` stays None)."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if not _is_container(node):
            return next(it)
        built = {step: build(child) for step, child in _children(node)}
        if isinstance(node, dict):
            return {k: built[f"[{k!r}]"] for k in node}
        values = list(built.values())
        return type(node)(*values) if _is_namedtuple(node) \
            else type(node)(values)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` over the leaves of trees of one structure."""
    flat = [tree_leaves(t) for t in (tree, *rest)]
    if any(len(f) != len(flat[0]) for f in flat):
        raise ValueError("trees of different structure")
    return tree_unflatten(tree, [fn(*xs) for xs in zip(*flat)])


__all__ = ["PyTree", "leaves_with_path", "tree_leaves", "tree_map",
           "tree_unflatten"]
