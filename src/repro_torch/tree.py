"""Trees of tensors: nested dicts, lists and tuples with tensors (or other
values) at the leaves, as the port keeps parameters and training state.

Dict keys are visited in sorted order, as ``jax.tree`` flattens a dict, so
a sum over the leaves adds them in the order ``repro`` does.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def _children(tree) -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return ((str(k), tree[k]) for k in sorted(tree))
    return ((str(i), x) for i, x in enumerate(tree))


def is_node(tree) -> bool:
    return isinstance(tree, (dict, list, tuple))


def leaves_with_paths(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[Tuple[str, ...], Any]]:
    """Every leaf with its path of keys (list indices as strings)."""
    if not is_node(tree):
        return [(prefix, tree)]
    out = []
    for key, sub in _children(tree):
        out.extend(leaves_with_paths(sub, prefix + (key,)))
    return out


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); a tree of the results."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, x, *(r[i] for r in rest)) for i, x in enumerate(tree))
    return fn(tree, *rest)


def _build(node, it: Iterator[Any]):
    if isinstance(node, dict):
        built = {k: _build(node[k], it) for k in sorted(node)}
        return {k: built[k] for k in node}
    if isinstance(node, (list, tuple)):
        return type(node)(_build(x, it) for x in node)
    return next(it)


def tree_unflatten(template, flat: List[Any]):
    """A tree of ``template``'s structure whose leaves are ``flat``, in the
    order :func:`leaves` gives (dict keys sorted).  No closure: a nested
    function that recursed through its own cell would make a reference cycle
    holding ``flat``'s iterator, so the leaves (a training step's
    gradients) would live until the garbage collector next ran."""
    return _build(template, iter(flat))
