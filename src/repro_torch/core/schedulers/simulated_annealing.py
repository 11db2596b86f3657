"""Simulated annealing baseline (paper appendix comparison).

Neighborhood move: swap one selected device with one free device. Geometric
cooling. Fitness = estimated TotalCost.

Two search backends (``search_backend``):

- ``fused`` (default): ``chains`` parallel SA chains on the cost model's
  device (``repro_torch.core.search.sa_search``), one program per decision
  instead of ``steps`` sequential host round-trips, with the greedy plan
  seeding chain 0. ``steps`` counts PER-CHAIN iterations, so the fused
  default spends ``chains * steps`` cost evaluations per decision; for a
  matched budget against ``host``, divide ``steps`` by ``chains`` and raise
  ``cooling`` to the ``chains``-th power.
- ``host``: the historical sequential numpy loop, scoring one plan per step
  through ``CostModel.cost_batch`` (P = 1).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import search
from repro_torch.core.plans import random_plans
from repro_torch.core.schedulers.base import SchedulerBase, SchedulingContext
from repro_torch.experiment.registry import register_scheduler


@register_scheduler("sa")
class SimulatedAnnealingScheduler(SchedulerBase):
    name = "sa"

    def __init__(self, cost_model, seed: int = 0, steps: int = 200,
                 t0: float = 1.0, cooling: float = 0.97, chains: int = 8,
                 search_backend: str = "fused"):
        super().__init__(cost_model, seed, search_backend=search_backend)
        self.steps = steps
        self.t0 = t0
        self.cooling = cooling
        self.chains = chains

    def schedule(self, ctx: SchedulingContext) -> np.ndarray:
        if self.search_backend == "fused":
            cm = self.cost_model
            plan = search.sa_search(
                self.rng, ctx.times32(), ctx.counts, ctx.available,
                ctx.n_sel, alpha=cm.alpha, beta=cm.beta,
                time_scale=cm.time_scale, fairness_scale=cm.fairness_scale,
                delta_fairness=cm.delta_fairness, steps=self.steps,
                chains=self.chains, t0=self.t0, cooling=self.cooling,
                avail_idx=ctx.available_indices(), device=cm.device,
                num_shards=cm.num_shards)
            return self._score_plan(ctx, plan)
        return self._schedule_host(ctx)

    def _schedule_host(self, ctx: SchedulingContext) -> np.ndarray:
        cur = random_plans(self.rng, ctx.available, ctx.n_sel, 1)[0]
        cur_cost = float(self._cost_of(ctx, cur[None])[0])
        best, best_cost = cur.copy(), cur_cost
        temp = self.t0
        # The free pool (available & ~plan) has CONSTANT size across swap
        # moves (every move trades one selected for one free device), so a
        # swapless schedule is detectable up front — no mid-loop break that
        # would leave the cooling schedule half-applied.
        if not np.any(ctx.available & ~cur):
            return self._score_plan(ctx, best)
        for _ in range(self.steps):
            nxt = cur.copy()
            on = np.flatnonzero(nxt)
            off = np.flatnonzero(ctx.available & ~nxt)
            nxt[self.rng.choice(on)] = False
            nxt[self.rng.choice(off)] = True
            nxt_cost = float(self._cost_of(ctx, nxt[None])[0])
            # Clamped Metropolis exponent: a pathological cost spike must
            # not overflow exp (RuntimeWarning) — past ±60 the accept
            # probability is saturated anyway.
            dc = nxt_cost - cur_cost
            accept_p = np.exp(np.clip(-dc / max(temp, 1e-9), -60.0, 0.0))
            if dc < 0 or self.rng.random() < accept_p:
                cur, cur_cost = nxt, nxt_cost
                if cur_cost < best_cost:
                    best, best_cost = cur.copy(), cur_cost
            temp *= self.cooling
        return self._score_plan(ctx, best)
