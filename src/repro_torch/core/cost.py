"""The paper's cost model.

Formula 2:  Cost_m^r(V) = alpha * T_m^r(V) + beta * F_m^r(V)
Formula 3:  T_m^r(V)    = max_{k in V} t_m^k
Formula 5:  F_m^r(V)    = Var_k(s_{k,m}^r)   (population variance over ALL K devices)
Formula 8:  TotalCost   = sum_m Cost_m^r  (other jobs' in-flight plans are context)

Costs are evaluated two ways:
- ``estimate``: expected times (used by schedulers to search plans);
- ``realize``:  sampled times from Formula 4 (used by the engine to advance
  the simulated clock — the number the paper reports).

All batched evaluation routes through ``repro_torch.core.scoring`` — one
scoring path (numpy / torch / cuda by ``scoring_backend``, on ``device``)
under every scheduler; the scalar helpers stay plain numpy.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.core import scoring
from repro_torch.core.devices import DevicePool


@dataclasses.dataclass
class CostModel:
    pool: DevicePool
    alpha: float = 1.0
    beta: float = 1.0
    # Normalizers keep the two terms commensurate (paper: alpha/beta tuned
    # empirically; we normalize by running scales so alpha=beta=1 is sane).
    time_scale: float = 1.0
    fairness_scale: float = 1.0
    # Scheduling uses the per-round fairness INCREMENT var(s+v) - var(s):
    # identical argmin to the paper's absolute var(s+v) (the subtrahend is
    # constant w.r.t. the candidate), but scale-stationary over rounds — the
    # absolute variance grows ~linearly with r, which would drown the time
    # term and break GP stationarity for BODS / reward stationarity for RLDS.
    # Records still report the paper's absolute Formula-5 value.
    delta_fairness: bool = True
    # Batched-scoring backend: "numpy" | "torch" | "cuda" | "auto" (auto
    # picks numpy for small P*K, the torch path at fleet scale).
    scoring_backend: str = "auto"
    # Where the torch/cuda scoring backends run: the card unless the caller
    # asks for the CPU.
    device: str = "cuda"
    # Fleet-axis shards for the scoring core and the fused searches (see
    # repro_torch.core.shard): 1 = single lane; >1 splits the K axis of
    # cost_batch/cost_indices and the parallel axes of SA/GA/BODS into
    # blocks. Plumbed from FleetSpec.num_shards.
    num_shards: int = 1

    # ---- Formula 5 ----

    def fairness(self, counts: np.ndarray, plan: Optional[np.ndarray] = None) -> float:
        """Variance of scheduling frequency if ``plan`` were applied on top of counts.

        ``counts``: (K,) cumulative times device k has been scheduled to the job.
        ``plan``:   optional (K,) bool/0-1 — the candidate round plan.
        """
        s = counts if plan is None else counts + plan
        return float(np.var(s))

    def fairness_batch(self, counts: np.ndarray, plans: np.ndarray) -> np.ndarray:
        """(P,) fairness for P candidate plans (P, K)."""
        return scoring.fairness_batch(counts, plans,
                                      delta_fairness=self.delta_fairness,
                                      backend=self.scoring_backend,
                                      device=self.device)

    # ---- Formula 3 ----

    def round_time(self, times: np.ndarray, plan: np.ndarray) -> float:
        """max over selected devices; empty plan -> 0."""
        sel = times[plan.astype(bool)]
        return float(sel.max()) if sel.size else 0.0

    def round_time_batch(self, times: np.ndarray, plans: np.ndarray) -> np.ndarray:
        return scoring.round_time_batch(times, plans,
                                        backend=self.scoring_backend,
                                        device=self.device)

    # ---- Formula 2 ----

    def cost(self, times: np.ndarray, counts: np.ndarray, plan: np.ndarray) -> float:
        t = self.round_time(times, plan) / self.time_scale
        f = self.fairness(counts, plan)
        if self.delta_fairness:
            f -= self.fairness(counts)
        return self.alpha * t + self.beta * f / self.fairness_scale

    def cost_batch(self, times: np.ndarray, counts: np.ndarray,
                   plans: np.ndarray, backend: Optional[str] = None) -> np.ndarray:
        """(P,) Formula-2 costs via the batched scoring core (one fused
        masked-max + variance reduction, never two passes)."""
        return scoring.score_plans(
            times, counts, plans, alpha=self.alpha, beta=self.beta,
            time_scale=self.time_scale, fairness_scale=self.fairness_scale,
            delta_fairness=self.delta_fairness,
            backend=backend if backend is not None else self.scoring_backend,
            device=self.device, num_shards=self.num_shards)

    def cost_indices(self, times: np.ndarray, counts: np.ndarray,
                     idx: np.ndarray, backend: Optional[str] = None) -> np.ndarray:
        """(P,) Formula-2 costs for plans in INDEX form ((P, n_sel) device
        ids) — the fleet fast path: P*n_sel gathered elements instead of a
        P*K dense sweep."""
        return scoring.score_plan_indices(
            times, counts, idx, alpha=self.alpha, beta=self.beta,
            time_scale=self.time_scale, fairness_scale=self.fairness_scale,
            delta_fairness=self.delta_fairness,
            backend=backend if backend is not None else self.scoring_backend,
            device=self.device, num_shards=self.num_shards)

    # ---- Formula 8 (TotalCost): current job's candidate + other jobs' fixed plans ----

    def total_cost_batch(
        self,
        job: int,
        tau: float,
        counts: np.ndarray,           # (K,) frequency counts of the current job
        plans: np.ndarray,            # (P, K) candidates for the current job
        other_costs: float = 0.0,     # sum of Cost_m' for jobs m' != m (constants)
        times: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        if times is None:
            times = self.pool.expected_times(job, tau)
        return self.cost_batch(times, counts, plans) + other_costs

    def calibrate(self, taus: Sequence[float], n_sel: int) -> None:
        """Set time/fairness normalizers from the pool so alpha,beta are unitless.

        time_scale ~ median expected round time over jobs; fairness_scale ~ the
        variance increment a single maximally-unfair round would add.
        """
        t = self.pool.expected_times_all(taus)                 # (M, K) fused
        ksel = min(n_sel, t.shape[1])
        fastest = np.partition(t, ksel - 1, axis=1)[:, :ksel]  # smallest per job
        self.time_scale = float(np.median(np.median(fastest, axis=1))) or 1.0
        # Fairness increment scale: adding one round moves var(s) by O(n_sel/K)
        # around its mean drift — normalize so a typical increment is O(1).
        k = self.pool.num_devices
        p = n_sel / k
        self.fairness_scale = max(p * (1 - p), 1e-6)
