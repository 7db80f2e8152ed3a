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


def leaves_with_path(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(keystr, leaf) pairs in JAX's flatten order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_path(tree[k], f"{prefix}[{k!r}]")
    elif _is_namedtuple(tree):
        for name, v in zip(tree._fields, tree):
            yield from leaves_with_path(v, f"{prefix}.{name}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_path(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in leaves_with_path(tree)]


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
