"""Scheduling-plan representation and invariants.

A plan is a boolean vector over the K devices with exactly ``n_sel`` True
entries, all of which must be available (not occupied by another job).
These invariants are property-tested in tests/test_schedulers.py.
"""

from __future__ import annotations

import numpy as np


def empty_plan(num_devices: int) -> np.ndarray:
    return np.zeros(num_devices, dtype=bool)


def plan_from_indices(num_devices: int, idx) -> np.ndarray:
    p = empty_plan(num_devices)
    p[np.asarray(idx, dtype=int)] = True
    return p


def random_plan_indices(
    rng: np.random.Generator, available: np.ndarray, n_sel: int, count: int
) -> np.ndarray:
    """(count, n_sel) int32 device ids — uniform sampling without replacement.

    Fully vectorized: one (count, |avail|) key draw + batched argpartition,
    instead of ``count`` sequential ``rng.choice`` calls — the difference
    between milliseconds and minutes when proposing 4096 candidates over a
    100k-device fleet. This INDEX form is also the scoring core's fast
    path (``scoring.score_plan_indices`` never touches a (P, K) dense
    array); ``random_plans`` is the same draw scattered to dense bool.
    """
    avail_idx = np.flatnonzero(available)
    if avail_idx.size < n_sel:
        raise ValueError(f"need {n_sel} available devices, have {avail_idx.size}")
    if n_sel == 0 or count == 0:
        return np.zeros((count, n_sel), dtype=np.int32)
    keys = rng.random((count, avail_idx.size))
    sel = np.argpartition(keys, n_sel - 1, axis=1)[:, :n_sel]
    return avail_idx[sel].astype(np.int32)


def indices_to_plans(idx: np.ndarray, num_devices: int,
                     dtype=bool) -> np.ndarray:
    """(count, n_sel) device ids -> (count, K) dense plans.

    ``dtype=np.int8`` produces the scoring core's compact mirror directly
    (0/1 bytes): ``scoring.score_plans`` converts bool plans to int8 before
    the device reduction anyway, so int8-from-the-start skips one (P, K)
    materialization on the hot path.
    """
    idx = np.asarray(idx)
    plans = np.zeros((idx.shape[0], num_devices), dtype=dtype)
    if idx.size:
        rows = np.repeat(np.arange(idx.shape[0]), idx.shape[1])
        plans[rows, idx.ravel()] = True
    return plans


def random_plans(
    rng: np.random.Generator, available: np.ndarray, n_sel: int, count: int,
    dtype=bool
) -> np.ndarray:
    """(count, K) random valid plans drawn from the available set."""
    idx = random_plan_indices(rng, available, n_sel, count)
    return indices_to_plans(idx, available.shape[0], dtype=dtype)


def gumbel_topk_plans(
    rng: np.random.Generator, logits: np.ndarray, available: np.ndarray,
    n_sel: int
) -> np.ndarray:
    """(count, K) plans via batched Gumbel top-k over per-plan logits.

    ``logits``: (count, K) (or (K,), broadcast) — a Plackett-Luce draw
    without replacement per row, restricted to the available set. This is
    the shared candidate-proposal primitive (BODS structured candidates,
    RLDS policy converter) in one vectorized pass.
    """
    logits = np.atleast_2d(np.asarray(logits, dtype=np.float64))
    count, K = logits.shape
    g = logits + rng.gumbel(size=(count, K))
    g = np.where(available[None, :], g, -np.inf)
    plans = np.zeros((count, K), dtype=bool)
    if n_sel == 0 or count == 0:
        return plans
    sel = np.argpartition(-g, n_sel - 1, axis=1)[:, :n_sel]
    np.put_along_axis(plans, sel, True, axis=1)
    return plans


def validate_plan(plan: np.ndarray, available: np.ndarray, n_sel: int) -> None:
    assert plan.dtype == bool and plan.ndim == 1
    assert int(plan.sum()) == n_sel, (int(plan.sum()), n_sel)
    assert not np.any(plan & ~available), "plan uses occupied device(s)"


def repair_plan(
    rng: np.random.Generator, plan: np.ndarray, available: np.ndarray, n_sel: int
) -> np.ndarray:
    """Force a candidate onto the feasible set: drop occupied, fix cardinality."""
    p = plan & available
    n = int(p.sum())
    if n > n_sel:  # drop random extras
        on = np.flatnonzero(p)
        off = rng.choice(on, size=n - n_sel, replace=False)
        p[off] = False
    elif n < n_sel:  # top up from available complement
        free = np.flatnonzero(available & ~p)
        add = rng.choice(free, size=n_sel - n, replace=False)
        p[add] = True
    return p


def repair_plans(
    rng: np.random.Generator, plans: np.ndarray, available: np.ndarray,
    n_sel: int
) -> np.ndarray:
    """Vectorized ``repair_plan``: a whole (P, K) population in one pass.

    Same semantics per row — occupied devices dropped, valid selections kept
    (random extras dropped when over ``n_sel``, random available top-ups when
    under), idempotent on already-valid plans — via one priority top-k
    instead of P Python loops: key = 1[selected & available] + U(0, 1),
    masked to -inf off the available set; the ``n_sel`` largest keys are the
    repaired selection. Like ``repair_plan``, raises when the available set cannot host
    ``n_sel`` devices.
    """
    plans = np.atleast_2d(np.asarray(plans, dtype=bool))
    P, K = plans.shape
    if n_sel == 0 or P == 0:
        return np.zeros((P, K), dtype=bool)
    n_avail = int(np.count_nonzero(available))
    if n_avail < n_sel:
        raise ValueError(f"need {n_sel} available devices, have {n_avail}")
    keys = (plans & available[None, :]) + rng.random((P, K))
    keys = np.where(available[None, :], keys, -np.inf)
    sel = np.argpartition(-keys, n_sel - 1, axis=1)[:, :n_sel]
    out = np.zeros((P, K), dtype=bool)
    np.put_along_axis(out, sel, True, axis=1)
    return out
