"""Server-side aggregation.

``fedavg``: data-size-weighted average of device models (McMahan 2017),
over a pytree whose leaves carry a leading device axis (the output of the
vmapped local trainer). ``fedavg_compressed`` aggregates top-k sparsified
deltas with server-side decompression: per leaf, one batched top-k over
the device axis, then one weighted scatter-add of the (n, k) sparse stream
(``repro_torch.kernels``: the CUDA kernel on the card, the plain version on
the CPU), so no dense per-device delta is materialised.
``fedavg_compressed_loop`` keeps the one-device-at-a-time path as the
semantics reference.
"""

from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.optim.compression import (topk_compress, topk_count,
                                           topk_decompress)
from repro_torch.tree import tree_leaves, tree_map

PyTree = Any


def _lane_shape(w: torch.Tensor, leaf: torch.Tensor):
    return w.reshape((-1,) + (1,) * (leaf.dim() - 1))


def fedavg(stacked_params: PyTree, weights: torch.Tensor) -> PyTree:
    """weights: (n_devices,) — normalized inside. Zero-weight lanes
    contribute exactly nothing."""
    w = weights / torch.clamp(weights.sum(), min=1e-12)
    return tree_map(lambda leaf: (leaf * _lane_shape(w, leaf)).sum(dim=0),
                    stacked_params)


# ---- robust aggregation (fault screening) ----
#
# THE rejection rule — one definition, two implementations (the tensor
# ``rejection_mask`` the fused round runs, and the numpy
# ``rejection_mask_host`` reference it is parity-tested against):
#
#   participating = weight > 0
#   finite_i      = every leaf of device i's update is finite
#   norm_i        = || update_i - global ||_2   (float32, over all leaves)
#   med           = lower median of norm over participating finite devices
#   keep_i        = participating_i & finite_i & (norm_i <= mult * med + eps)
#
# A single surviving lane is its own median and is kept unconditionally.

_REJECT_EPS = 1e-6


def _delta_sq_norms(global_params: PyTree, stacked_params: PyTree, xp) -> Any:
    """(n,) squared delta norms in float32, leaves in the reference's order.
    ``xp`` is ``torch`` (tensors) or ``numpy`` (arrays)."""
    sq = None
    for g, s in zip(tree_leaves(global_params), tree_leaves(stacked_params)):
        d = (xp.asarray(s, dtype=xp.float32)
             - xp.asarray(g, dtype=xp.float32)[None])
        n = d.shape[0]
        part = (d.reshape(n, -1) ** 2).sum(1)
        sq = part if sq is None else sq + part
    return sq


def _all_finite(stacked_params: PyTree, xp) -> Any:
    fin = None
    for s in tree_leaves(stacked_params):
        n = s.shape[0]
        part = xp.isfinite(xp.asarray(s, dtype=xp.float32)).reshape(
            n, -1).all(1)
        fin = part if fin is None else fin & part
    return fin


def rejection_mask(global_params: PyTree, stacked_params: PyTree,
                   weights: torch.Tensor, mult) -> torch.Tensor:
    """(n,) bool keep mask under THE rejection rule, on the device (no host
    synchronisation)."""
    part = weights > 0
    finite = _all_finite(stacked_params, torch)
    norm = torch.sqrt(_delta_sq_norms(global_params, stacked_params, torch))
    valid = part & finite
    ranked = torch.sort(torch.where(valid, norm, torch.inf)).values
    cnt = valid.sum()
    med = ranked[torch.clamp(cnt - 1, min=0) // 2]  # lower median
    # Median-of-one: a single surviving lane IS its own median, so the
    # threshold test is vacuous (and with mult < 1 would reject the only
    # update there is). NaN norms compare False; the finite guard stays.
    return part & finite & ((norm <= mult * med + _REJECT_EPS) | (cnt <= 1))


def _to_numpy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def rejection_mask_host(global_params: PyTree, stacked_params: PyTree,
                        weights, mult: float) -> np.ndarray:
    """Numpy reference of ``rejection_mask``."""
    global_params = tree_map(_to_numpy, global_params)
    stacked_params = tree_map(_to_numpy, stacked_params)
    weights = np.asarray(_to_numpy(weights))
    part = weights > 0
    with np.errstate(invalid="ignore", over="ignore"):
        finite = np.asarray(_all_finite(stacked_params, np))
        norm = np.sqrt(np.asarray(
            _delta_sq_norms(global_params, stacked_params, np)))
    valid = part & finite
    if not valid.any():
        return np.zeros_like(part)
    if int(valid.sum()) == 1:
        # Median-of-one: the sole survivor is its own median — keep it.
        return valid.copy()
    med = np.sort(norm[valid])[(int(valid.sum()) - 1) // 2]
    with np.errstate(invalid="ignore"):
        ok = norm <= float(mult) * med + _REJECT_EPS
    return part & finite & np.where(np.isnan(norm), False, ok)


def robust_fedavg(global_params: PyTree, stacked_params: PyTree,
                  weights: torch.Tensor, mult
                  ) -> Tuple[PyTree, torch.Tensor]:
    """FedAvg over the lanes that survive the rejection rule.

    Rejected lanes are ZEROED before averaging (a NaN lane with zero weight
    would still poison ``sum(leaf * w)``), and when every lane is rejected
    the previous global params are returned unchanged. Returns
    ``(new_params, keep_mask)``.
    """
    ok = rejection_mask(global_params, stacked_params, weights, mult)
    okf = ok.to(torch.float32)
    cleaned = tree_map(
        lambda leaf: torch.where(_lane_shape(ok, leaf), leaf,
                                 torch.zeros((), dtype=leaf.dtype,
                                             device=leaf.device)),
        stacked_params)
    avg = fedavg(cleaned, weights * okf)
    any_kept = (weights * okf).sum() > 0
    new = tree_map(lambda a, g: torch.where(any_kept, a, g), avg,
                   global_params)
    return new, ok


def fedavg_compressed(global_params: PyTree, stacked_params: PyTree,
                      weights: torch.Tensor, ratio: float,
                      impl: str = "cuda") -> PyTree:
    """Devices upload top-k sparsified DELTAS; the server averages them.

    Per leaf, one ``torch.topk`` over every device's delta row, then one
    weighted scatter-add of the (n, k) stream (``impl``: ``cuda`` launches
    the kernel on CUDA tensors and is the plain version on CPU tensors;
    ``ref`` is the plain version). Returns the new global model.
    """
    w = (weights / torch.clamp(weights.sum(), min=1e-12)).to(torch.float32)

    def per_leaf(g, s):
        n = s.shape[0]
        flat = (s - g[None]).reshape(n, -1)            # (n, size) deltas
        k = min(topk_count(ratio, g.numel()), flat.shape[1])
        idx = torch.topk(flat.abs(), k, dim=1).indices
        vals = torch.gather(flat, 1, idx)
        agg = ops.scatter_add(vals, idx, w, g.numel(), impl=impl)
        return g + agg.to(g.dtype).reshape(g.shape)

    return tree_map(per_leaf, global_params, stacked_params)


def fedavg_compressed_loop(global_params: PyTree, stacked_params: PyTree,
                           weights: torch.Tensor, ratio: float) -> PyTree:
    """One device at a time, one dense decompressed delta per device: the
    numerical-equivalence contract for ``fedavg_compressed``."""
    n = weights.shape[0]
    w = weights / torch.clamp(weights.sum(), min=1e-12)

    def one_device(i):
        delta = tree_map(lambda s, g: s[i] - g, stacked_params, global_params)
        (vals, idx), _ = topk_compress(delta, ratio)
        return topk_decompress(vals, idx, global_params)

    agg = tree_map(lambda d: d * w[0], one_device(0))
    for i in range(1, n):
        agg = tree_map(lambda a, d: a + d * w[i], agg, one_device(i))
    return tree_map(lambda g, d: g + d, global_params, agg)
