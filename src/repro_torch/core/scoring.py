"""Batched plan-scoring core: one scoring path under every scheduler.

Every scheduler reduces to the same inner loop — score P candidate plans
over K devices with Formula 2:

    cost(V) = alpha * max_{k in V} t_k / time_scale
            + beta  * [Var(c + v) (- Var(c))] / fairness_scale

``score_plans`` is that loop, batched, with interchangeable backends:

- ``numpy`` — the seed implementation, bit-identical to the reference's
  ``numpy`` backend (small pools, zero dispatch overhead);
- ``torch`` — one fused float32 reduction on tensors on ``device`` (the
  port of the reference's jitted ``jax`` backend);
- ``cuda``  — the hand-written kernel ``repro_torch.kernels.sched_score``
  (sufficient statistics) and a float64 combine on the host (the port of
  the reference's ``pallas`` backend). It has no fallback: with
  ``device="cuda"`` on a machine without a GPU it raises.

``backend="auto"`` picks numpy below a per-form element threshold and
torch above; ``backend=None`` is the process default (``auto`` unless
``set_default_backend`` says otherwise). ``num_shards`` > 1 splits the
fleet (K) axis into blocks (``repro_torch.core.shard``): each block is
reduced to the per-plan statistics (by the kernel under ``cuda``) and the
blocks are combined on the host in float64. ``device`` is where the tensor
backends run: ``"cuda"`` unless the caller asks for the CPU. The
host-facing API is numpy in, numpy out; ``score_dense``, ``score_index``,
``fairness_dense`` and ``round_time_dense`` are the plain functions on
tensors underneath.
"""

from __future__ import annotations

import threading
from typing import Optional, Union

import numpy as np
import torch

VALID_BACKENDS = ("auto", "numpy", "torch", "cuda")

# Below these many elements the numpy path wins over a device dispatch.
# These values were calibrated on a CPU for the reference's jax backend
# (dense crossover between P*K = 2.6e5 and 4.1e5; index form a factor of
# 4 higher). They are still to be measured on the H100.
AUTO_NUMPY_MAX_DENSE = 1 << 18
AUTO_NUMPY_MAX_INDEX = 1 << 20
# Sharded fleets dispatch on the PER-SHARD size against this much smaller
# floor: a fleet someone shards stays on the tensor path unless each
# shard's problem is tiny. (Comparing the per-shard count against the
# single-lane caps would make numpy more likely as shards are added.)
MIN_SHARD_ELEMENTS = 1 << 12

DeviceLike = Union[str, torch.device]

_state = threading.local()


def set_default_backend(backend: str) -> None:
    """This thread's backend for calls that pass ``backend=None``."""
    if backend not in VALID_BACKENDS:
        raise ValueError(f"backend {backend!r} not in {VALID_BACKENDS}")
    _state.backend = backend


def get_default_backend() -> str:
    return getattr(_state, "backend", "auto")


def resolve_backend(backend: Optional[str], num_elements: int,
                    form: str = "dense", num_shards: int = 1) -> str:
    """Concrete backend for an ``num_elements``-sized scoring problem
    (``form`` is ``dense`` for a (P, K) sweep, ``index`` for a (P, n_sel)
    gather: ``auto`` uses a separate threshold per form). ``None`` is the
    process default. With ``num_shards`` > 1 ``auto`` compares the
    per-shard element count against ``MIN_SHARD_ELEMENTS`` instead."""
    b = backend if backend is not None else get_default_backend()
    if b not in VALID_BACKENDS:
        raise ValueError(f"backend {b!r} not in {VALID_BACKENDS}")
    if b == "auto":
        if num_shards and num_shards > 1:
            return ("numpy" if num_elements // num_shards
                    <= MIN_SHARD_ELEMENTS else "torch")
        cap = AUTO_NUMPY_MAX_INDEX if form == "index" else AUTO_NUMPY_MAX_DENSE
        return "numpy" if num_elements <= cap else "torch"
    return b


def resolve_device(device: DeviceLike) -> torch.device:
    """``torch.device(device)``; raises for a CUDA device on a machine
    without one (no silent move to the CPU)."""
    d = torch.device(device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    return d


def h2d(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host numpy array -> tensor on ``device`` (the per-call copy of the
    searchers' plans; a CUDA copy from pageable memory blocks the host)."""
    return torch.from_numpy(np.ascontiguousarray(array)).to(device)


def _plans_int8(plans: np.ndarray) -> np.ndarray:
    # Bool plans reinterpret as their 0/1 bytes: no (P, K) copy.
    if plans.dtype == np.int8:
        return plans
    if plans.dtype == np.bool_:
        return plans.view(np.int8)
    return plans.astype(np.int8)


# ---- plain functions on tensors (the torch backend) ----------------------

def _fairness_from(wsum, n, counts_c, K: float, delta_fairness: bool):
    # counts_c (..., K) against wsum and n (..., P): the count sums keep a
    # trailing axis of 1 so that each batch row meets its own plans.
    c1 = counts_c.sum(dim=-1, keepdim=True)
    if delta_fairness:
        # Var(c+v) - Var(c), expanded: cancellation-free at any scale.
        return wsum / K - (2.0 * c1 * n + n * n) / (K * K)
    c2 = (counts_c * counts_c).sum(dim=-1, keepdim=True)
    return (c2 + wsum) / K - ((c1 + n) / K) ** 2


def _masked_wsum(sel: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    # (..., P, K) selections, (..., K) weights -> (..., P). Accumulated in
    # float64, rounded to float32 once: plans selecting the same multiset
    # of weights score identically wherever the devices sit (a float32
    # tree sum can differ by an ulp between such plans, which would turn
    # the host searchers' exact ties into position noise).
    return torch.where(sel, w[..., None, :], 0.0).sum(
        dim=-1, dtype=torch.float64).to(torch.float32)


def score_dense(times: torch.Tensor, counts_c: torch.Tensor,
                plans: torch.Tensor, alpha: float, beta: float, ts: float,
                fs: float, delta_fairness: bool) -> torch.Tensor:
    """(K,) f32 times, (K,) f32 mean-centred counts, (P, K) int8 plans ->
    (P,) f32 Formula-2 costs, one fused reduction on the inputs' device."""
    K = float(times.shape[0])  # float: K*K overflows int32 at K=100k
    sel = plans != 0
    t = torch.where(sel, times[None, :], -torch.inf).amax(dim=1)
    t = torch.where(torch.isfinite(t), t, 0.0)
    # Fairness via sufficient statistics (v in {0,1}):
    #   sum(s) = sum(c) + n,  sum(s^2) = sum(c^2) + sum_{sel} (2c + 1)
    w = 2.0 * counts_c + 1.0
    n = sel.sum(dim=1).to(torch.float32)
    wsum = _masked_wsum(sel, w)
    f = _fairness_from(wsum, n, counts_c, K, delta_fairness)
    return alpha * t / ts + beta * f / fs


def score_index(times: torch.Tensor, counts_c: torch.Tensor,
                idx: torch.Tensor, alpha: float, beta: float, ts: float,
                fs: float, delta_fairness: bool) -> torch.Tensor:
    """Index-form twin of ``score_dense``: (P, n_sel) int device ids."""
    K = float(counts_c.shape[0])
    n = float(idx.shape[1])
    t = times[idx].amax(dim=1)
    w = 2.0 * counts_c + 1.0
    wsum = w[idx].sum(dim=1)
    f = _fairness_from(wsum, n, counts_c, K, delta_fairness)
    return alpha * t / ts + beta * f / fs


def fairness_dense(counts_c: torch.Tensor, plans: torch.Tensor,
                   delta_fairness: bool) -> torch.Tensor:
    """(..., P) Formula-5 fairness (or its increment) from (..., K) centred
    counts and (..., P, K) plans: leading batch dims pair each counts
    vector with its own plans (the gym's E environments)."""
    K = float(counts_c.shape[-1])
    sel = plans != 0
    w = 2.0 * counts_c + 1.0
    n = sel.sum(dim=-1).to(torch.float32)
    return _fairness_from(_masked_wsum(sel, w), n, counts_c, K,
                          delta_fairness)


def round_time_dense(times: torch.Tensor, plans: torch.Tensor) -> torch.Tensor:
    """(..., P) Formula-3 round time (masked max; empty plan -> 0) from
    (..., K) times and (..., P, K) plans."""
    t = torch.where(plans != 0, times[..., None, :], -torch.inf).amax(dim=-1)
    return torch.where(torch.isfinite(t), t, 0.0)


def _f32(x: np.ndarray, device: torch.device) -> torch.Tensor:
    return h2d(np.asarray(x, dtype=np.float32), device)


def _f32_scalars(*xs: float):
    # The coefficients as float32 values (the reference passes
    # jnp.float32 scalars), handed to torch as Python floats.
    return tuple(float(np.float32(x)) for x in xs)


def _to_host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().astype(np.float64)


# ---- numpy reference (the seed semantics, bit-for-bit) ------------------

def _score_numpy(times, counts, plans, alpha, beta, ts, fs, delta_fairness):
    sel = plans.astype(bool)
    masked = np.where(sel, times[None, :], -np.inf)
    t = masked.max(axis=1)
    t = np.where(np.isfinite(t), t, 0.0) / ts
    f = np.var(counts[None, :] + plans, axis=1)
    if delta_fairness:
        f = f - np.var(counts)
    return alpha * t + beta * f / fs


def _score_from_stats(stats, counts, alpha, beta, ts, fs, delta_fairness):
    """(P, 3) kernel stats -> (P,) costs (cheap host-side combine)."""
    t_max = stats[:, 0].astype(np.float64)
    n = stats[:, 1].astype(np.float64)
    wsum = stats[:, 2].astype(np.float64)
    K = counts.shape[0]
    t = np.where(t_max > -1e29, t_max, 0.0) / ts
    c1 = float(np.sum(counts))
    if delta_fairness:
        f = wsum / K - (2.0 * c1 * n + n * n) / (K * K)
    else:
        c2 = float(np.sum(np.square(counts, dtype=np.float64)))
        f = (c2 + wsum) / K - ((c1 + n) / K) ** 2
    return alpha * t + beta * f / fs


# ---- public API ---------------------------------------------------------

def score_plans(times: np.ndarray, counts: np.ndarray, plans: np.ndarray,
                alpha: float = 1.0, beta: float = 1.0,
                time_scale: float = 1.0, fairness_scale: float = 1.0,
                delta_fairness: bool = True,
                backend: Optional[str] = None,
                device: DeviceLike = "cuda",
                num_shards: int = 1) -> np.ndarray:
    """Score P candidate plans: (K,) times, (K,) counts, (P, K) plans -> (P,).

    ``backend`` is ``numpy | torch | cuda | auto`` (None: the process
    default); ``device`` is where ``torch`` and ``cuda`` run. With
    ``num_shards`` > 1 both take ``shard.plan_stats_sharded``: kernel 2.1
    (``cuda``) or the plain partials (``torch``) on each block of the fleet
    axis, combined on the host in float64."""
    times = np.asarray(times)
    counts = np.asarray(counts)
    plans = np.asarray(plans)
    if plans.ndim == 1:
        plans = plans[None, :]
    P, K = plans.shape
    b = resolve_backend(backend, P * K, num_shards=num_shards)
    if b == "numpy":
        return _score_numpy(times, counts, plans, alpha, beta,
                            time_scale, fairness_scale, delta_fairness)
    # Variance is shift-invariant: center counts once in f64 so the f32
    # backends never cancel two large sums (exact parity at fleet scale,
    # where cumulative counts grow without bound).
    counts_c = counts.astype(np.float64) - float(np.mean(counts))
    if num_shards and num_shards > 1:
        from repro_torch.core import shard

        stats = shard.plan_stats_sharded(times, counts_c, plans, "dense",
                                         num_shards, backend=b, device=device)
        return _score_from_stats(stats, counts_c, alpha, beta,
                                 time_scale, fairness_scale, delta_fairness)
    dev = resolve_device(device)
    if b == "torch":
        out = score_dense(_f32(times, dev), _f32(counts_c, dev),
                          h2d(_plans_int8(plans), dev),
                          *_f32_scalars(alpha, beta, time_scale,
                                        fairness_scale),
                          bool(delta_fairness))
        return _to_host(out)
    stats = plan_stats_cuda(times, counts_c, plans, device=dev)
    return _score_from_stats(stats, counts_c, alpha, beta,
                             time_scale, fairness_scale, delta_fairness)


def score_plan_indices(times: np.ndarray, counts: np.ndarray,
                       idx: np.ndarray, alpha: float = 1.0, beta: float = 1.0,
                       time_scale: float = 1.0, fairness_scale: float = 1.0,
                       delta_fairness: bool = True,
                       backend: Optional[str] = None,
                       device: DeviceLike = "cuda",
                       num_shards: int = 1) -> np.ndarray:
    """Score P candidate plans given in INDEX form: (P, n_sel) device ids.

    P*n_sel gathered elements instead of a P*K dense sweep; semantically
    identical to ``score_plans`` on the scattered dense plans. The index
    form has no kernel: ``cuda`` runs the ``torch`` gather, as the
    reference's ``pallas`` runs its ``jax`` gather. With ``num_shards`` > 1
    each block of the fleet axis masks the gather to the ids it owns."""
    times = np.asarray(times)
    counts = np.asarray(counts)
    idx = np.asarray(idx)
    if idx.ndim == 1:
        idx = idx[None, :]
    P, S = idx.shape
    K = counts.shape[0]
    if S == 0:
        if delta_fairness:
            return np.zeros(P, dtype=np.float64)
        return np.full(P, beta * float(np.var(counts)) / fairness_scale)
    b = resolve_backend(backend, P * S, form="index", num_shards=num_shards)
    if b == "numpy":
        t = times[idx].max(axis=1) / time_scale
        w = 2.0 * counts + 1.0
        wsum = w[idx].sum(axis=1)
        c1 = float(np.sum(counts))
        if delta_fairness:
            f = wsum / K - (2.0 * c1 * S + S * S) / (K * K)
        else:
            c2 = float(np.sum(np.square(counts, dtype=np.float64)))
            f = (c2 + wsum) / K - ((c1 + S) / K) ** 2
        return alpha * t + beta * f / fairness_scale
    counts_c = counts.astype(np.float64) - float(np.mean(counts))
    if num_shards and num_shards > 1:
        from repro_torch.core import shard

        stats = shard.plan_stats_sharded(times, counts_c, idx, "index",
                                         num_shards, backend=b, device=device)
        return _score_from_stats(stats, counts_c, alpha, beta,
                                 time_scale, fairness_scale, delta_fairness)
    dev = resolve_device(device)
    out = score_index(_f32(times, dev), _f32(counts_c, dev),
                      h2d(idx.astype(np.int64), dev),
                      *_f32_scalars(alpha, beta, time_scale, fairness_scale),
                      bool(delta_fairness))
    return _to_host(out)


def plan_stats_cuda(times: np.ndarray, counts: np.ndarray, plans: np.ndarray,
                    device: DeviceLike = "cuda") -> np.ndarray:
    """The ``cuda`` backend's reduction: (P, 3) [max_t, n_sel, sum(2c+1)]
    from ``kernels.ops.sched_plan_stats(impl="cuda")`` on ``device``."""
    from repro_torch.kernels import ops

    dev = resolve_device(device)
    w = 2.0 * np.asarray(counts, np.float32) + 1.0
    plans = np.asarray(plans)
    if plans.ndim == 1:
        plans = plans[None, :]
    out = ops.sched_plan_stats(_f32(times, dev), _f32(w, dev),
                               h2d(_plans_int8(plans), dev), impl="cuda")
    return out.cpu().numpy()


def round_time_batch(times: np.ndarray, plans: np.ndarray,
                     backend: Optional[str] = None,
                     device: DeviceLike = "cuda") -> np.ndarray:
    """(P,) Formula-3 round time (masked max; empty plan -> 0). ``cuda``
    runs the ``torch`` reduction (no kernel of its own)."""
    times = np.asarray(times)
    plans = np.asarray(plans)
    if plans.ndim == 1:
        plans = plans[None, :]
    b = resolve_backend(backend, plans.size)
    if b == "numpy":
        masked = np.where(plans.astype(bool), times[None, :], -np.inf)
        out = masked.max(axis=1)
        return np.where(np.isfinite(out), out, 0.0)
    dev = resolve_device(device)
    return _to_host(round_time_dense(_f32(times, dev),
                                     h2d(_plans_int8(plans), dev)))


def fairness_batch(counts: np.ndarray, plans: np.ndarray,
                   delta_fairness: bool = False,
                   backend: Optional[str] = None,
                   device: DeviceLike = "cuda") -> np.ndarray:
    """(P,) Formula-5 fairness (variance of counts + plan; optionally the
    per-round increment Var(c+v) - Var(c)). ``cuda`` runs the ``torch``
    reduction (no kernel of its own)."""
    counts = np.asarray(counts)
    plans = np.asarray(plans)
    if plans.ndim == 1:
        plans = plans[None, :]
    b = resolve_backend(backend, plans.size)
    if b == "numpy":
        f = np.var(counts[None, :] + plans, axis=1)
        if delta_fairness:
            f = f - np.var(counts)
        return f
    counts_c = counts.astype(np.float64) - float(np.mean(counts))
    dev = resolve_device(device)
    return _to_host(fairness_dense(_f32(counts_c, dev),
                                   h2d(_plans_int8(plans), dev),
                                   bool(delta_fairness)))
