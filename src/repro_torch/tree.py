"""Parameter trees: nested lists, tuples and dicts of tensors.

The CNN zoo's params are a list of per-layer dicts, as in the reference, so
``torch.func`` treats them as a pytree and FedAvg is a weighted mean over a
leading axis of every leaf. Leaves are visited in JAX's order (dict keys
sorted, a NamedTuple's fields in field order), so sums over leaves (the
robust-aggregation norms) add in the reference's order and a checkpoint's
leaves line up with the reference's. As in JAX, ``None`` is an empty
subtree, not a leaf.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

import numpy as np
import torch

Tree = Any


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def tree_leaves(tree: Tree) -> List[Any]:
    return [leaf for _, leaf in tree_flatten_with_paths(tree)]


def tree_flatten_with_paths(tree: Tree) -> List[Tuple[str, Any]]:
    """``(key, leaf)`` pairs in JAX's order, each key the path's parts
    joined by ``/`` as the reference's checkpoint writes them: a dict key
    as ``str(key)``, a list or tuple index as its number, a NamedTuple
    field as ``.<field>``."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        parts = [(str(k), tree[k]) for k in sorted(tree)]
    elif _is_namedtuple(tree):
        parts = [(f".{f}", getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, (list, tuple)):
        parts = [(str(i), t) for i, t in enumerate(tree)]
    else:
        return [("", tree)]
    return [(f"{head}/{key}" if key else head, leaf)
            for head, sub in parts
            for key, leaf in tree_flatten_with_paths(sub)]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure), rebuilding ``tree``'s structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, t, *(r[i] for r in rest))
               for i, t in enumerate(tree)]
        if isinstance(tree, list):
            return out
        if _is_namedtuple(tree):  # e.g. optimizer state
            return type(tree)(*out)
        return type(tree)(out)
    return fn(tree, *rest)


def tree_unflatten(like: Tree, leaves: List[Any]) -> Tree:
    """``like``'s structure with its leaves replaced by ``leaves``, taken
    in ``tree_flatten_with_paths`` order (as many as ``like`` has)."""
    it = iter(leaves)

    def rebuild(tree):
        if tree is None:
            return None
        if isinstance(tree, dict):
            new = {k: rebuild(tree[k]) for k in sorted(tree)}
            return {k: new[k] for k in tree}
        if isinstance(tree, (list, tuple)):
            out = [rebuild(t) for t in tree]
            if isinstance(tree, list):
                return out
            if _is_namedtuple(tree):
                return type(tree)(*out)
            return type(tree)(out)
        return next(it)

    return rebuild(like)


def as_tensor(leaf, device, dtype=None) -> torch.Tensor:
    """A leaf (a tensor, or a numpy array or scalar as the reference's
    state gives it) as a tensor on ``device``, copied from the host."""
    if not isinstance(leaf, torch.Tensor):
        leaf = torch.from_numpy(np.array(leaf))
    return leaf.to(device=device, dtype=dtype)
