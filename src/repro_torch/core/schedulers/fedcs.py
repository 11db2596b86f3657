"""FedCS (Nishio & Yonetani 2019) adapted to multi-job FL.

FedCS greedily accepts clients under a round deadline, visiting them in a
RANDOM order (which is where its partial fairness comes from), and keeps the
plan within the deadline budget. If fewer than n_sel fit the deadline, the
deadline is relaxed; if more fit, the first n_sel accepted are kept.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.plans import plan_from_indices
from repro_torch.core.schedulers.base import SchedulerBase, SchedulingContext
from repro_torch.experiment.registry import register_scheduler


@register_scheduler("fedcs")
class FedCSScheduler(SchedulerBase):
    name = "fedcs"

    def __init__(self, cost_model, seed: int = 0,
                 deadline_quantile: float = 0.6,
                 search_backend: str = "fused"):
        super().__init__(cost_model, seed, search_backend=search_backend)
        self.deadline_quantile = deadline_quantile

    def schedule(self, ctx: SchedulingContext) -> np.ndarray:
        avail = ctx.available_indices()  # cached per round (shared w/ engine)
        times = ctx.expected_times
        deadline = np.quantile(times[avail], self.deadline_quantile)
        order = self.rng.permutation(avail)
        fits = times[order] <= deadline
        chosen = order[fits][: ctx.n_sel]
        if chosen.size < ctx.n_sel:  # relax: admit the fastest remaining
            rest = order[~fits]
            rest = rest[np.argsort(times[rest], kind="stable")]
            chosen = np.concatenate([chosen, rest[: ctx.n_sel - chosen.size]])
        plan = plan_from_indices(ctx.available.shape[0], chosen)
        return self._score_plan(ctx, plan)
