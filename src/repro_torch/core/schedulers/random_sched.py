"""Random scheduling — FedAvg's device selection (McMahan et al. 2017b)."""

from __future__ import annotations

import numpy as np

from repro_torch.core.plans import random_plans
from repro_torch.core.schedulers.base import SchedulerBase, SchedulingContext
from repro_torch.experiment.registry import register_scheduler


@register_scheduler("random")
class RandomScheduler(SchedulerBase):
    name = "random"

    def schedule(self, ctx: SchedulingContext) -> np.ndarray:
        plan = random_plans(self.rng, ctx.available, ctx.n_sel, 1)[0]
        return self._score_plan(ctx, plan)
