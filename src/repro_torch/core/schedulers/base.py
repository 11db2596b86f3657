"""Scheduler interface (Formula 9): pick V_m^r ⊂ K \\ V_o minimizing TotalCost."""

from __future__ import annotations

import abc
import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.cost import CostModel


@dataclasses.dataclass
class SchedulingContext:
    """Everything a scheduler may look at when planning one round of one job."""

    job: int                    # index m of the job being scheduled
    round_idx: int              # r
    tau: float                  # local epochs tau_m
    n_sel: int                  # |V_m^r| = C_m * |K|
    available: np.ndarray       # (K,) bool — K \ V_o at this instant
    counts: np.ndarray          # (K,) s_{k,m}: cumulative scheduling frequency of job m
    expected_times: np.ndarray  # (K,) E[t_m^k] from the pool's time model
    other_costs: float = 0.0    # sum of other jobs' in-flight round costs (Formula 8)
    # Observed realized cost of the previous round of this job (schedulers that
    # learn online — BODS, RLDS — consume this as feedback).
    last_plan: Optional[np.ndarray] = None
    last_cost: Optional[float] = None
    # Per-round derived-array caches, computed at most ONCE per context (the
    # engine builds one context per launch): the float32 expected-time mirror
    # every device search/scoring path consumes, and the available-device id
    # list the closed-form schedulers (greedy/FedCS) and the engine share.
    # Lazy so host-only paths never pay for them; init=False so no
    # constructor (or dataclasses.replace) can smuggle in a stale cache.
    _times32: Optional[np.ndarray] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)
    _avail_idx: Optional[np.ndarray] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    def times32(self) -> np.ndarray:
        """float32 mirror of ``expected_times`` (cached per round)."""
        if self._times32 is None:
            self._times32 = self.expected_times.astype(np.float32)
        return self._times32

    def available_indices(self) -> np.ndarray:
        """``np.flatnonzero(available)`` (cached per round)."""
        if self._avail_idx is None:
            self._avail_idx = np.flatnonzero(self.available)
        return self._avail_idx


class SchedulerBase(abc.ABC):
    """Stateful per-experiment scheduler. One instance schedules ALL jobs.

    ALL batched plan evaluation flows through ``repro_torch.core.scoring`` (via
    ``cost_model.cost_batch``): the searchers (BODS/RLDS/genetic/SA/DNN)
    score their candidate sets there, and the closed-form baselines
    (greedy/FedCS/random) score their chosen plan there via
    ``_score_plan`` — one scoring path under every scheduler.
    """

    name: str = "base"

    #: Which plan-search implementation ``schedule`` runs: ``"fused"`` (the
    #: default) runs the search loops of ``repro_torch.core.search`` on the
    #: cost model's device; ``"host"`` keeps the historical sequential
    #: numpy path. Schedulers
    #: without a search loop (random/greedy/FedCS/DNN/RLDS) accept and
    #: ignore the knob — their one code path serves both settings.
    SEARCH_BACKENDS = ("host", "fused")

    def __init__(self, cost_model: CostModel, seed: int = 0,
                 search_backend: str = "fused"):
        if search_backend not in self.SEARCH_BACKENDS:
            raise ValueError(f"search_backend {search_backend!r} not in "
                             f"{self.SEARCH_BACKENDS}")
        self.cost_model = cost_model
        self.rng = np.random.default_rng(seed)
        self.search_backend = search_backend
        # Estimated Formula-2 cost of the most recently returned plan.
        self.last_estimated_cost: Optional[float] = None

    @abc.abstractmethod
    def schedule(self, ctx: SchedulingContext) -> np.ndarray:
        """Return a (K,) bool plan with exactly ctx.n_sel devices, all available."""

    def observe(self, ctx: SchedulingContext, plan: np.ndarray, realized_cost: float) -> None:
        """Feedback after the round really ran (default: no-op)."""

    # ---- persistence / warm hand-off -------------------------------------
    #
    # Every scheduler participates in the policy-zoo and scheduler-service
    # persistence protocols. The closed-form schedulers (random/greedy/
    # FedCS/SA/genetic) have no learned state, so the defaults are empty;
    # the learners (BODS/RLDS/DNN) override with their rings/params.

    def state_dict(self) -> dict:
        """Learned state as a checkpointable pytree (default: stateless)."""
        return {}

    def load_state_dict(self, tree: dict) -> None:
        """Restore learned state (default: no-op)."""

    def snapshot(self) -> dict:
        """FULL in-memory snapshot: ``state_dict`` plus the host PRNG state.
        Unlike the zoo-persisted ``state_dict`` (portable, array-only), a
        snapshot pins the numpy Generator too, so ``restore`` reproduces the
        next decision bit-for-bit — the scheduler-service warm hand-off
        across a retire/readmit cycle."""
        return {"state": self.state_dict(),
                "rng": self.rng.bit_generator.state}

    def restore(self, snap: dict) -> None:
        self.load_state_dict(snap["state"])
        self.rng.bit_generator.state = snap["rng"]

    # ---- dynamic job set -------------------------------------------------

    def ensure_jobs(self, num_jobs: int) -> None:
        """Grow per-job state to ``num_jobs`` rows (dynamic job admission —
        the engine calls this from ``add_job``). Default: no per-job state."""

    def job_state_dict(self, job: int) -> dict:
        """Per-job learned state (a retiring tenant's slice), for warm
        hand-off when the tenant is readmitted under a NEW job id. Default:
        nothing job-specific."""
        return {}

    def load_job_state(self, job: int, tree: dict) -> None:
        """Restore one job's slice saved by ``job_state_dict`` (default:
        no-op)."""

    # Shared helper: batch-estimate candidate TotalCosts under the context.
    def _cost_of(self, ctx: SchedulingContext, plans: np.ndarray) -> np.ndarray:
        return self.cost_model.total_cost_batch(
            job=ctx.job,
            tau=ctx.tau,
            counts=ctx.counts,
            plans=plans,
            other_costs=ctx.other_costs,
            times=ctx.expected_times,
        )

    # Own-job estimated cost (no cross-job constant): comparable to the
    # engine's realized-cost feedback, so learned schedulers can form
    # realized-estimated residuals that are stationary across rounds.
    def _own_cost_of(self, ctx: SchedulingContext, plans: np.ndarray) -> np.ndarray:
        return self.cost_model.total_cost_batch(
            job=ctx.job,
            tau=ctx.tau,
            counts=ctx.counts,
            plans=plans,
            other_costs=0.0,
            times=ctx.expected_times,
        )

    # Closed-form schedulers (greedy/FedCS/random) call this on their chosen
    # plan so even non-searching baselines flow through the scoring core.
    # Uses the INDEX fast path (n_sel gathers, not a K-wide dense pass) and
    # feeds the engine's RoundRecord.est_cost — the estimated-vs-realized
    # residual is exactly the quantity the learned schedulers model.
    def _score_plan(self, ctx: SchedulingContext, plan: np.ndarray) -> np.ndarray:
        idx = np.flatnonzero(plan)[None, :]
        self.last_estimated_cost = float(self.cost_model.cost_indices(
            ctx.expected_times, ctx.counts, idx)[0])
        return plan

