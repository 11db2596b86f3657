"""Greedy scheduling (Shi, Zhou, Niu 2020): fastest available devices first.

The paper observes this maximizes per-round speed but starves slow devices'
data (poor fairness) -> accuracy collapse on non-IID. Kept faithful.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.plans import plan_from_indices
from repro_torch.core.schedulers.base import SchedulerBase, SchedulingContext
from repro_torch.experiment.registry import register_scheduler


@register_scheduler("greedy")
class GreedyScheduler(SchedulerBase):
    name = "greedy"

    def schedule(self, ctx: SchedulingContext) -> np.ndarray:
        # The context's cached available-id list (shared with the engine and
        # FedCS this round) replaces a K-wide masked copy: the selection
        # runs over the |avail|-sized gather of the pool's cached
        # expected-time row.
        avail = ctx.available_indices()
        t_av = ctx.expected_times[avail]
        # argpartition: the paper's top-n_sel-fastest rule is selection, not
        # a full sort — O(K) instead of O(K log K) on 100k-device fleets.
        cut = np.argpartition(t_av, ctx.n_sel - 1)[: ctx.n_sel]
        idx = avail[cut[np.argsort(t_av[cut], kind="stable")]]
        plan = plan_from_indices(ctx.available.shape[0], idx)
        return self._score_plan(ctx, plan)
