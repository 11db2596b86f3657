"""The device pool's time model (Formula 4), Formulas 2, 3 and 5, and a
replay of the cohorts a run launched against them and, where the
scheduler is BODS, against the plans BODS would weigh (``bods.Replay``).

Formula 4: t_m^k = tau_m a_k D_k^m + Exp(scale = tau_m D_k^m / mu_k).
Formula 3: T_m^r(V) = max_{k in V} t_m^k.  Formula 5: F = Var_k(s_k + v_k).
Formula 2: Cost = alpha T / time_scale + beta dF / fairness_scale, with dF
the increment Var(s + v) - Var(s) (the cost model's ``delta_fairness``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from portbench.reference import bods as ref_bods


@dataclasses.dataclass
class Pool:
    a: np.ndarray             # (K,)
    mu: np.ndarray            # (K,)
    data_sizes: np.ndarray    # (K, M) float64
    rng: np.random.Generator  # the realized-time stream

    @classmethod
    def heterogeneous(cls, num_devices: int, num_jobs: int, seed: int,
                      a_range, mu_range, data_range) -> "Pool":
        rng = np.random.default_rng(seed)
        a = np.exp(rng.uniform(np.log(a_range[0]), np.log(a_range[1]),
                               num_devices))
        mu = rng.uniform(*mu_range, num_devices)
        d = rng.integers(data_range[0], data_range[1],
                         size=(num_devices, num_jobs))
        return cls(a=a, mu=mu, data_sizes=d.astype(np.float64), rng=rng)

    def expected_times(self, job: int, tau: float) -> np.ndarray:
        d = self.data_sizes[:, job]
        return tau * (d * (self.a + 1.0 / self.mu))

    def sample_times(self, job: int, tau: float) -> np.ndarray:
        """One round's realized times for all K devices, in the order of
        operations the engine uses (so the floats agree)."""
        d = self.data_sizes[:, job]
        e = self.rng.standard_exponential(self.a.shape[0])
        out = e * (d / self.mu)
        out *= tau
        out += tau * (d * self.a)
        return out


def calibrate(pool: Pool, taus: Sequence[float], n_sel: int
              ) -> Tuple[float, float]:
    """(time_scale, fairness_scale): the median over jobs of the median of
    the n_sel fastest expected times, and p (1 - p) for p = n_sel / K."""
    t = np.stack([pool.expected_times(m, tau) for m, tau in enumerate(taus)])
    k = min(n_sel, t.shape[1])
    fastest = np.partition(t, k - 1, axis=1)[:, :k]
    time_scale = float(np.median(np.median(fastest, axis=1))) or 1.0
    p = n_sel / t.shape[1]
    return time_scale, max(p * (1 - p), 1e-6)


def rel_gap(a: float, b: float) -> float:
    """|a - b| / |b| (|a - b| where b is 0); inf where either is not finite."""
    if a is None or b is None or not (np.isfinite(a) and np.isfinite(b)):
        return float("inf")
    return abs(a - b) / abs(b) if b != 0 else abs(a - b)


def replay_cohorts(pool: Pool, launches: List[Tuple[int, int, np.ndarray]],
                   records: Dict[Tuple[int, int], dict], taus: Sequence[float],
                   n_sel: int, alpha: float, beta: float,
                   bods: Optional[ref_bods.Settings] = None,
                   scheduler_seed: int = 0) -> Dict[str, float]:
    """Hold every launched cohort to the engine's guarantees and Formulas
    2-5, in launch order, and, given ``bods`` settings, each plan to the
    decision BODS makes from ``scheduler_seed`` on the history so far
    (``bods_regret``: the worst regret of a launched plan).

    ``launches``: (job, round, device ids) as the runtime was told to train
    them. ``records``: (job, round) -> the engine's record (``t_start``,
    ``t_end``, ``round_time``, ``cost``, ``fairness``, ``est_cost``) of each
    finished round. A round's launch instant is its record's ``t_start``,
    or its job's previous round's ``t_end`` where the round has no record
    yet. Returns the worst reading of each number.
    """
    K, M = pool.data_sizes.shape
    time_scale, fairness_scale = calibrate(pool, taus, n_sel)
    busy_until = np.zeros(K)
    counts = np.zeros((M, K))
    out = dict(cohort_faults=0.0, round_time_gap=0.0, cost_gap=0.0,
               est_cost_gap=0.0)
    replay = None
    if bods is not None:
        out["bods_regret"] = 0.0
        replay = ref_bods.Replay(M, K, pool.mu, scheduler_seed, alpha, beta,
                                 time_scale, fairness_scale, bods)
    for job, rnd, ids in launches:
        ids = np.asarray(ids, np.int64)
        rec = records.get((job, rnd))
        if rec is not None:
            now = rec["t_start"]
        elif rnd == 0:
            now = 0.0
        else:
            now = records[(job, rnd - 1)]["t_end"]
        tau = taus[job]
        wait = np.maximum(busy_until - now, 0.0)
        ctx = ref_bods.Context(job, wait <= 1e-12, counts[job].copy(),
                               pool.expected_times(job, tau) + wait, n_sel)
        times = pool.sample_times(job, tau)
        ok = (ids.size == n_sel and np.unique(ids).size == ids.size
              and ids.min() >= 0 and ids.max() < K
              and bool(np.all(busy_until[ids] <= now + 1e-12)))
        if not ok:
            out["cohort_faults"] += 1.0
            ids = ids[(ids >= 0) & (ids < K)]
        plan = np.zeros(K)
        plan[ids] = 1.0
        round_time = float(times[ids].max()) if ids.size else 0.0
        fair = float(np.var(counts[job] + plan))
        dfair = fair - float(np.var(counts[job]))
        cost = alpha * round_time / time_scale + beta * dfair / fairness_scale
        expected = pool.expected_times(job, tau)
        est = (alpha * (float(expected[ids].max()) if ids.size else 0.0)
               / time_scale + beta * dfair / fairness_scale)
        if rec is not None:
            out["round_time_gap"] = max(out["round_time_gap"],
                                        rel_gap(rec["round_time"], round_time),
                                        rel_gap(rec["t_end"] - now,
                                                round_time))
            out["cost_gap"] = max(out["cost_gap"], rel_gap(rec["cost"], cost),
                                  rel_gap(rec["fairness"], fair))
            out["est_cost_gap"] = max(out["est_cost_gap"],
                                      rel_gap(rec["est_cost"], est))
        if replay is not None:
            out["bods_regret"] = max(out["bods_regret"],
                                     replay.regret(ctx, plan > 0))
            replay.observe(ctx, plan > 0, cost)
        busy_until[ids] = np.maximum(busy_until[ids], now + times[ids])
        counts[job][ids] += 1.0
    return out
