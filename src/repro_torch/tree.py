"""Pytree helpers over nested dicts, lists, tuples and NamedTuples of
tensors, in JAX's leaf order (dict keys sorted, sequences by index,
NamedTuple fields in order, ``None`` holding no leaf).

Paths print as ``jax.tree_util.keystr`` prints them, e.g.
``.params['segments'][0][0]['attn']['wq']``, so checkpoints and bridged
parameters use the same keys in both packages.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def leaves_with_path(tree, prefix: str = "", is_leaf: Callable = None
                     ) -> Iterator[Tuple[str, Any]]:
    """(keystr, leaf) pairs in JAX's flatten order.  ``is_leaf(x)`` true
    makes ``x`` a leaf whatever its type (a sharding spec's tuple)."""
    if tree is None:
        return
    if is_leaf is not None and is_leaf(tree):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_path(tree[k], f"{prefix}[{k!r}]", is_leaf)
    elif _is_namedtuple(tree):
        for name, v in zip(tree._fields, tree):
            yield from leaves_with_path(v, f"{prefix}.{name}", is_leaf)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_path(v, f"{prefix}[{i}]", is_leaf)
    else:
        yield prefix, tree


def leaves(tree, is_leaf: Callable = None) -> List[Any]:
    return [leaf for _, leaf in leaves_with_path(tree, is_leaf=is_leaf)]


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leafwise over trees of one structure, visiting leaves in
    flatten order."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def unflatten(like, new_leaves) -> Any:
    """Tree of ``like``'s structure holding ``new_leaves`` in flatten
    order."""
    it = iter(new_leaves)
    out = tree_map(lambda _: next(it), like)
    end = object()
    if next(it, end) is not end:
        raise ValueError("more leaves than the tree holds")
    return out
