"""Genetic-algorithm scheduling (Barika et al. 2019) on the plan bit-vectors.

Population of valid plans; tournament selection; uniform crossover + repair
(cardinality and availability restored); mutation swaps a selected device for
a free one. Fitness = -TotalCost (estimated).

Two search backends (``search_backend``):

- ``fused`` (default): all generations on the cost model's device
  (``repro_torch.core.search.ga_search``): an index-form population,
  host-drawn tournaments and noise, and the greedy plan seeding individual 0.
- ``host``: the historical per-individual numpy loops, scoring the whole
  population every generation through ``CostModel.cost_batch`` (the dense
  (P, K) sweep: the ``cuda`` scoring backend's kernel).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import search
from repro_torch.core.plans import random_plans, repair_plan
from repro_torch.core.schedulers.base import SchedulerBase, SchedulingContext
from repro_torch.experiment.registry import register_scheduler


@register_scheduler("genetic")
class GeneticScheduler(SchedulerBase):
    name = "genetic"

    def __init__(self, cost_model, seed: int = 0, population: int = 32,
                 generations: int = 12, mutation_rate: float = 0.2,
                 search_backend: str = "fused"):
        super().__init__(cost_model, seed, search_backend=search_backend)
        self.population = population
        self.generations = generations
        self.mutation_rate = mutation_rate

    def schedule(self, ctx: SchedulingContext) -> np.ndarray:
        if self.search_backend == "fused":
            cm = self.cost_model
            plan = search.ga_search(
                self.rng, ctx.times32(), ctx.counts, ctx.available,
                ctx.n_sel, alpha=cm.alpha, beta=cm.beta,
                time_scale=cm.time_scale, fairness_scale=cm.fairness_scale,
                delta_fairness=cm.delta_fairness,
                population=self.population, generations=self.generations,
                mutation_rate=self.mutation_rate,
                avail_idx=ctx.available_indices(), device=cm.device,
                num_shards=cm.num_shards)
            return self._score_plan(ctx, plan)
        pop = random_plans(self.rng, ctx.available, ctx.n_sel, self.population)
        for _ in range(self.generations):
            cost = self._cost_of(ctx, pop)
            pop = self._next_generation(ctx, pop, cost)
        cost = self._cost_of(ctx, pop)
        return self._score_plan(ctx, pop[int(np.argmin(cost))])

    def _next_generation(self, ctx, pop, cost):
        P = pop.shape[0]
        # Tournament selection (size 2).
        a, b = self.rng.integers(0, P, (2, P))
        parents = np.where((cost[a] <= cost[b])[:, None], pop[a], pop[b])
        # Uniform crossover between consecutive parents, then repair.
        children = parents.copy()
        for i in range(0, P - 1, 2):
            mask = self.rng.random(pop.shape[1]) < 0.5
            c0 = np.where(mask, parents[i], parents[i + 1])
            c1 = np.where(mask, parents[i + 1], parents[i])
            children[i] = repair_plan(self.rng, c0, ctx.available, ctx.n_sel)
            children[i + 1] = repair_plan(self.rng, c1, ctx.available, ctx.n_sel)
        # Mutation: swap one in-plan device for one free device.
        for i in range(P):
            if self.rng.random() < self.mutation_rate:
                on = np.flatnonzero(children[i])
                off = np.flatnonzero(ctx.available & ~children[i])
                if on.size and off.size:
                    children[i][self.rng.choice(on)] = False
                    children[i][self.rng.choice(off)] = True
        # Elitism: keep the best parent.
        best = int(np.argmin(cost))
        children[0] = pop[best]
        return children
