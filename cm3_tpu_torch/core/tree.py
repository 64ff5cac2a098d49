"""Nested-dict helpers: the port's stand-in for ``jax.tree_util`` over
the dicts of tensors that observations, states and transitions are."""

from __future__ import annotations

from typing import Any, Callable, Iterator, Tuple


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over dicts of equal structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) pairs in sorted-key order (the order
    ``jax.tree_util`` flattens a dict in)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            for path, leaf in tree_leaves(tree[k]):
                yield (k,) + path, leaf
    else:
        yield (), tree
