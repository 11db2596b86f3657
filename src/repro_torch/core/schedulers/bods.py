"""BODS — Bayesian Optimization-based Device Scheduling (paper Algorithm 1).

A Gaussian Process with a Matérn-5/2 kernel models the REALIZED TotalCost of
scheduling plans; each round candidates are sampled from the available set,
scored with Expected Improvement (paper Formula 15) against the best observed
cost, and the argmax is scheduled. ``observe()`` feeds the realized cost back
as a new observation point (Algorithm 1 lines 5-7).

Two engineering choices on top of the paper's sketch (both standard BO
practice; the GP/EI machinery is unchanged):

1. **Plan featurization.** The kernel acts on a low-dimensional feature map
   φ(V) = [estimated round time, fairness increment, mean/max expected time
   of selected, capability-jitter exposure, novelty] rather than the raw
   100-bit indicator vector. A stationary kernel on raw bits cannot express
   the "max over selected devices" structure of Formula 3; on φ the GP
   learns the realized-vs-estimated correction within tens of observations.
2. **Stratified candidate sampling** (Gumbel top-k with random time/fairness
   bias weights) so the proposal distribution actually contains low-cost
   plans; EI still arbitrates.

The GP observation buffer is FIXED-SIZE (ring, MAX_OBS) with a validity mask:
masked slots contribute identity Gram rows and zero cross-covariance — exact
no-ops in the posterior algebra. The rings are numpy arrays, as in the
reference, so ``state_dict`` crosses between the packages unchanged.

Search backends: ``fused`` (the default) runs the whole acquisition on the
cost model's device (``search.bods_acquire``: the candidate block never
leaves it, and its statistics come from the plan-scoring kernel); ``host``
draws the candidates from the numpy ``rng`` and scores them with
``search.ei_scores`` on that device.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import search
from repro_torch.core.plans import gumbel_topk_plans, random_plans, repair_plans
from repro_torch.core.schedulers.base import SchedulerBase, SchedulingContext
from repro_torch.core.scoring import h2d, resolve_device
from repro_torch.experiment.registry import register_scheduler

MAX_OBS = 256
NUM_FEATURES = 6


def _norm01(x: np.ndarray, mask: np.ndarray = None) -> np.ndarray:
    """[0, 1]-normalize ``x`` by the spread over ``mask`` (or all of x).

    A flat reference set (one free device, identical available devices)
    carries no signal, so the normalized feature is all-zeros there instead
    of inf/NaN logits.
    """
    ref = x[mask] if mask is not None else x
    if ref.size == 0:
        return np.zeros(x.shape, dtype=np.float64)
    lo = float(ref.min())
    spread = float(np.ptp(ref))
    if not np.isfinite(spread) or spread < 1e-9:
        return np.zeros(x.shape, dtype=np.float64)
    return np.clip((x - lo) / spread, 0.0, 1.0)


def _ei_scores(device, F, resid, valid, cand_feats, cand_est, noise):
    """``search.ei_scores`` on host arrays, computed on ``device``; numpy
    out. The GP prior mean is the scheduler's ESTIMATED cost; the GP models
    the realized-estimated residual, with the plugin incumbent."""
    dev = resolve_device(device)
    F, resid, valid, cand_feats, cand_est = (
        h2d(np.asarray(a, np.float32), dev)
        for a in (F, resid, valid, cand_feats, cand_est))
    return search.ei_scores(F, resid, valid, cand_feats, cand_est,
                            noise).cpu().numpy()


@register_scheduler("bods")
class BODSScheduler(SchedulerBase):
    name = "bods"

    def __init__(self, cost_model, seed: int = 0, num_candidates: int = 256,
                 init_points: int = 16, local_search: bool = True,
                 gp_noise: float = 0.25, search_backend: str = "fused"):
        super().__init__(cost_model, seed, search_backend=search_backend)
        self.num_candidates = num_candidates
        self.init_points = init_points
        self.local_search = local_search
        self.gp_noise = gp_noise
        M = cost_model.pool.num_jobs
        K = cost_model.pool.num_devices
        self._F = np.zeros((M, MAX_OBS, NUM_FEATURES), dtype=np.float32)
        self._plans = np.zeros((M, MAX_OBS, K), dtype=bool)
        self._y = np.zeros((M, MAX_OBS), dtype=np.float32)      # realized cost
        self._est = np.zeros((M, MAX_OBS), dtype=np.float32)    # estimated cost (prior mean)
        self._valid = np.zeros((M, MAX_OBS), dtype=np.float32)
        self._head = np.zeros(M, dtype=int)
        self._initialized = np.zeros(M, dtype=bool)

    # ---- persistence (policy zoo) ----

    def state_dict(self):
        """The GP observation rings (numpy, the reference's layout)."""
        return {"F": self._F, "plans": self._plans, "y": self._y,
                "est": self._est, "valid": self._valid, "head": self._head,
                "initialized": self._initialized}

    def load_state_dict(self, tree) -> None:
        """Restore the rings (copied: the source keeps its own)."""
        F = np.array(tree["F"], np.float32)
        plans = np.array(tree["plans"], bool)
        # The plans ring carries K, the F ring carries M — both must match.
        if F.shape != self._F.shape or plans.shape != self._plans.shape:
            raise ValueError(
                f"BODS observation ring shapes {F.shape}/{plans.shape} do "
                f"not match this pool/job mix "
                f"{self._F.shape}/{self._plans.shape}; BODS state is "
                "pool-specific")
        self._F = F
        self._plans = plans
        self._y = np.array(tree["y"], np.float32)
        self._est = np.array(tree["est"], np.float32)
        self._valid = np.array(tree["valid"], np.float32)
        self._head = np.array(tree["head"], int)
        self._initialized = np.array(tree["initialized"], bool)

    # ---- dynamic job set (scheduler service) ----

    def ensure_jobs(self, num_jobs: int) -> None:
        """Grow the per-job observation rings to ``num_jobs`` rows (newly
        admitted jobs start with an empty, uninitialized ring)."""
        M = self._F.shape[0]
        if num_jobs <= M:
            return
        n = num_jobs - M

        def grow(arr):
            pad = np.zeros((n,) + arr.shape[1:], dtype=arr.dtype)
            return np.concatenate([arr, pad], axis=0)

        self._F = grow(self._F)
        self._plans = grow(self._plans)
        self._y = grow(self._y)
        self._est = grow(self._est)
        self._valid = grow(self._valid)
        self._head = np.concatenate([self._head, np.zeros(n, dtype=int)])
        self._initialized = np.concatenate(
            [self._initialized, np.zeros(n, dtype=bool)])

    def job_state_dict(self, job: int) -> dict:
        """One job's GP observation ring — a retiring tenant's history."""
        return {"F": self._F[job].copy(), "plans": self._plans[job].copy(),
                "y": self._y[job].copy(), "est": self._est[job].copy(),
                "valid": self._valid[job].copy(),
                "head": int(self._head[job]),
                "initialized": bool(self._initialized[job])}

    def load_job_state(self, job: int, tree: dict) -> None:
        """Restore a tenant's ring under its NEW job id (warm hand-off)."""
        plans = np.asarray(tree["plans"], bool)
        if plans.shape != self._plans.shape[1:]:
            raise ValueError(
                f"BODS per-job ring shape {plans.shape} does not match "
                f"this pool's {self._plans.shape[1:]}")
        self._F[job] = np.asarray(tree["F"], np.float32)
        self._plans[job] = plans
        self._y[job] = np.asarray(tree["y"], np.float32)
        self._est[job] = np.asarray(tree["est"], np.float32)
        self._valid[job] = np.asarray(tree["valid"], np.float32)
        self._head[job] = int(tree["head"])
        self._initialized[job] = bool(tree["initialized"])

    # ---- plan featurization φ(V) ----

    def _featurize(self, ctx: SchedulingContext, plans: np.ndarray) -> np.ndarray:
        """(P, K) plans -> (P, d) features, all O(1)-normalized."""
        cm = self.cost_model
        t = ctx.expected_times
        est_time = cm.round_time_batch(t, plans) / cm.time_scale
        dfair = cm.fairness_batch(ctx.counts, plans) / cm.fairness_scale
        sel_t = np.where(plans, t[None, :], 0.0)
        n = np.maximum(plans.sum(1), 1)
        mean_t = sel_t.sum(1) / n / cm.time_scale
        mu = cm.pool.mu
        jitter = np.where(plans, (t / np.maximum(mu, 1e-9))[None, :], 0.0).max(1) / cm.time_scale
        novelty = np.where(plans, (ctx.counts == 0)[None, :], False).sum(1) / np.maximum(ctx.n_sel, 1)
        occupancy = plans.sum(1) / plans.shape[1]
        return np.stack([est_time, dfair, mean_t, jitter, novelty, occupancy],
                        axis=1).astype(np.float32)

    # ---- Algorithm 1, Line 1: random initial observations (estimated costs) ----

    def _bootstrap(self, ctx: SchedulingContext) -> None:
        plans = random_plans(self.rng, ctx.available, ctx.n_sel, self.init_points)
        costs = self._own_cost_of(ctx, plans)
        feats = self._featurize(ctx, plans)
        for p, f, c in zip(plans, feats, costs):
            self._push(ctx.job, p, f, float(c), float(c))
        self._initialized[ctx.job] = True

    def _push(self, job: int, plan: np.ndarray, feat: np.ndarray,
              cost: float, est: float) -> None:
        h = self._head[job] % MAX_OBS
        self._plans[job, h] = plan
        self._F[job, h] = feat
        self._y[job, h] = cost
        self._est[job, h] = est
        self._valid[job, h] = 1.0
        self._head[job] += 1

    # ---- candidate generation ----

    def _structured_candidates(self, ctx: SchedulingContext, count: int) -> np.ndarray:
        """Gumbel top-k draws with random time/fairness bias weights
        (degenerate-safe normalization: flat logits, never NaN)."""
        t_norm = _norm01(ctx.expected_times, ctx.available)
        c_norm = _norm01(ctx.counts)
        w_time = self.rng.uniform(0.0, 6.0, count)
        w_fair = self.rng.uniform(0.0, 4.0, count)
        logits = -w_time[:, None] * t_norm[None, :] - w_fair[:, None] * c_norm[None, :]
        return gumbel_topk_plans(self.rng, logits, ctx.available, ctx.n_sel)

    def _best_plan(self, job: int) -> np.ndarray:
        best_i = int(np.argmin(np.where(self._valid[job] > 0, self._y[job],
                                        np.inf)))
        return self._plans[job, best_i]

    # ---- Algorithm 1, Lines 3-4: candidates + EI argmax ----

    def schedule(self, ctx: SchedulingContext) -> np.ndarray:
        if not self._initialized[ctx.job]:
            self._bootstrap(ctx)
        if self.search_backend == "fused":
            return self._schedule_fused(ctx)
        n_rand = self.num_candidates // 4
        cands = np.concatenate([
            random_plans(self.rng, ctx.available, ctx.n_sel, n_rand),
            self._structured_candidates(ctx, self.num_candidates - n_rand),
        ])
        if self.local_search and self._head[ctx.job] > 0:
            # Mutations of the best observed plan, repaired onto the
            # feasible set — the proposal the fused path repairs on the
            # device.
            n_mut = min(32, self.num_candidates // 4)
            mutants = search._mutate_plan_host(
                self.rng, self._best_plan(ctx.job), n_mut)
            cands[:n_mut] = repair_plans(self.rng, mutants, ctx.available,
                                         ctx.n_sel)

        y = self._y[ctx.job]
        est = self._est[ctx.job]
        valid = self._valid[ctx.job]
        sd = y[valid > 0].std() + 1e-6 if valid.sum() else 1.0
        cand_feats = self._featurize(ctx, cands)
        cand_est = self._own_cost_of(ctx, cands).astype(np.float32)
        ei = _ei_scores(self.cost_model.device, self._F[ctx.job],
                        (y - est) / sd * valid,      # residual (normalized)
                        valid, cand_feats, cand_est / sd, self.gp_noise)
        choice = int(np.argmax(ei))
        self.last_estimated_cost = float(cand_est[choice])
        return cands[choice]

    # ---- fused acquisition: the whole of Lines 3-4 on the device ----

    def _schedule_fused(self, ctx: SchedulingContext) -> np.ndarray:
        """Candidate generation + featurization + GP/EI + argmax on the
        cost model's device (``search.bods_acquire``); only the ring
        slicing stays on the host."""
        j = ctx.job
        base_plan = None
        if self.local_search and self._head[j] > 0:
            base_plan = self._best_plan(j)
        cm = self.cost_model
        plan, est = search.bods_acquire(
            self.rng, ctx.times32(), ctx.counts, ctx.available,
            cm.pool.mu, ctx.n_sel,
            F=self._F[j], y=self._y[j], est=self._est[j],
            valid=self._valid[j], base_plan=base_plan,
            alpha=cm.alpha, beta=cm.beta, time_scale=cm.time_scale,
            fairness_scale=cm.fairness_scale,
            delta_fairness=cm.delta_fairness,
            num_candidates=self.num_candidates,
            n_mut=min(32, self.num_candidates // 4),
            local_search=self.local_search, gp_noise=self.gp_noise,
            avail_idx=ctx.available_indices(), device=cm.device,
            num_shards=cm.num_shards)
        self.last_estimated_cost = float(est)
        return plan

    # ---- Algorithm 1, Lines 6-7: realized cost becomes an observation ----

    def observe(self, ctx: SchedulingContext, plan: np.ndarray, realized_cost: float) -> None:
        feat = self._featurize(ctx, plan[None])[0]
        est = float(self._own_cost_of(ctx, plan[None])[0])
        self._push(ctx.job, plan, feat, realized_cost, est)
