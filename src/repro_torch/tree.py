"""Parameter trees: nested lists, tuples and dicts of tensors.

The CNN zoo's params are a list of per-layer dicts, as in the reference, so
``torch.func`` treats them as a pytree and FedAvg is a weighted mean over a
leading axis of every leaf. Leaves are visited in JAX's order (dict keys
sorted), so sums over leaves (the robust-aggregation norms) add in the
reference's order.
"""

from __future__ import annotations

from typing import Any, Callable, List

Tree = Any


def tree_leaves(tree: Tree) -> List[Any]:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure), rebuilding ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, t, *(r[i] for r in rest))
               for i, t in enumerate(tree)]
        return out if isinstance(tree, list) else type(tree)(out)
    return fn(tree, *rest)
