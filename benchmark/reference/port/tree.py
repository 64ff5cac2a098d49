"""Nested-structure helpers: the port's stand-in for ``jax.tree_util``
over the dicts of tensors that observations, states and transitions
are, and the dataclasses and tuples that hold them."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, Tuple


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over dicts, tuples and dataclasses of equal
    structure (a None is a leaf)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, v, *(r[i] for r in rest))
                     for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) pairs of a nested dict in sorted-key order (the order
    ``jax.tree_util`` flattens a dict in)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            for path, leaf in tree_leaves(tree[k]):
                yield (k,) + path, leaf
    else:
        yield (), tree
