"""Gradient compression: top-k sparsification with error feedback.

Used on the FL plane (device -> server uploads). ``topk_compress`` returns
(values, indices) of the k largest-magnitude entries per leaf; the residual
is carried in an error-feedback accumulator so compression bias vanishes
over steps (Karimireddy et al. 2019).

``k = int(max(1, round(ratio * size)))`` uses Python's ``round``, which
rounds half to even (``round(2.5) == 2``), as the reference does.

Ties: ``jax.lax.top_k`` breaks ties in |x| by the lower index, and
``torch.topk`` on CUDA promises no order among ties. A different pick
changes a result only where entries of equal |x| have different signs; the
port does not emulate the JAX order.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.tree import tree_map

PyTree = Any


class ErrorFeedbackState(NamedTuple):
    residual: PyTree


def topk_count(ratio: float, size: int) -> int:
    """Entries kept of a leaf of ``size`` (half to even, at least 1)."""
    return int(max(1, round(ratio * size)))


def _leaf_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    flat = x.reshape(-1)
    k = max(1, min(k, flat.shape[0]))
    _, idx = torch.topk(flat.abs(), k)
    return flat[idx], idx


def topk_compress(grads: PyTree, ratio: float,
                  ef: Optional[ErrorFeedbackState] = None):
    """Compress each leaf to ``topk_count(ratio, size)`` entries. Returns
    ((values, indices) pytrees, new_ef)."""
    if ef is not None:
        grads = tree_map(lambda g, r: g + r, grads, ef.residual)
    comp = tree_map(lambda g: _leaf_topk(g, topk_count(ratio, g.numel())),
                    grads)
    values = tree_map(lambda g, c: c[0], grads, comp)
    indices = tree_map(lambda g, c: c[1], grads, comp)

    def residual(g, i):
        flat = g.reshape(-1).clone()
        flat[i] = 0.0
        return flat.reshape(g.shape)

    new_ef = ErrorFeedbackState(tree_map(residual, grads, indices))
    return (values, indices), new_ef


def topk_decompress(values: PyTree, indices: PyTree, like: PyTree) -> PyTree:
    def per_leaf(v, i, g):
        flat = torch.zeros(g.numel(), dtype=g.dtype, device=g.device)
        flat[i] = v.to(g.dtype)
        return flat.reshape(g.shape)

    return tree_map(per_leaf, values, indices, like)
