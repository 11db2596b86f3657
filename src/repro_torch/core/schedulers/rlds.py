"""RLDS — Reinforcement Learning-based Device Scheduling (paper Algorithm 2).

Architecture (paper Fig. 2): an LSTM over the device sequence followed by a
fully-connected head emits a per-device scheduling probability; an ε-greedy
policy converter turns probabilities into a plan of exactly n_sel devices.
Training is REINFORCE (paper Formula 12) with an EMA baseline b_m per job:

    θ' = θ + η/N Σ_n Σ_k ∇ log P(S_k | S_{k-1:1}; θ) (R_n - b_m)

with reward R = -TotalCost. The policy is shared across jobs; per-device
features: [a_k, μ_k, E[t_k] (job-specific), fairness count s_{k,m},
availability, D_k^m]. Pre-training (paper Algorithm 3) runs LAZILY at the
first ``schedule()`` call against the estimated cost model with N plans per
synthetic round — or not at all when a trained state arrives first through
``load_state_dict``.

The policy math runs on the cost model's device: the LSTM is a loop of K
cells (full f32), the REINFORCE gradient comes from autograd, and the
optimizer is the reference's ``adamw`` (``repro_torch.optim.optimizers``)
with its ``OptState(step, (m, v))``. The initial params are drawn from a
CPU ``torch.Generator`` seeded by ``seed`` (the same on every device); the
numpy Generator drives the host-side ε-greedy/plan-repair sampling, call for
call as in the reference.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as tnf

from repro_torch.core.plans import gumbel_topk_plans, repair_plan
from repro_torch.core.schedulers.base import SchedulerBase, SchedulingContext
from repro_torch.core.scoring import h2d, resolve_device
from repro_torch.experiment.registry import register_scheduler
from repro_torch.optim.optimizers import OptState, adamw
from repro_torch.tree import as_tensor, tree_map

NUM_FEATURES = 6
HIDDEN = 64


def policy_optimizer(lr: float):
    """The RLDS policy optimizer (one definition, so saved optimizer
    moments always match the online settings)."""
    return adamw(lr, 0.9, 0.999, 1e-8, 0.0)


def init_policy(generator: torch.Generator, device="cpu"
                ) -> Dict[str, torch.Tensor]:
    """Glorot-init policy params drawn from ``generator`` (a CPU
    ``torch.Generator``), then moved to ``device``."""

    def glorot(shape):
        fan = sum(shape)
        w = torch.randn(shape, generator=generator, dtype=torch.float32)
        return (w * np.sqrt(2.0 / fan)).to(device)

    def zeros(n):
        return torch.zeros(n, dtype=torch.float32, device=device)

    return {
        "wi": glorot((NUM_FEATURES, 4 * HIDDEN)),   # input -> gates
        "wh": glorot((HIDDEN, 4 * HIDDEN)),          # hidden -> gates
        "b": zeros(4 * HIDDEN),
        "w_out": glorot((HIDDEN, 1)),
        "b_out": zeros(1),
    }


def _policy_logits(params, feats):
    """feats: (..., K, F) -> logits (..., K). An LSTM over the device
    sequence; the input projection has no recurrent dependency and is one
    (K, F) @ (F, 4H) matmul before the loop."""
    xw = feats @ params["wi"] + params["b"]      # (..., K, 4H)
    h = torch.zeros(xw.shape[:-2] + (HIDDEN,), dtype=xw.dtype,
                    device=xw.device)
    c = h
    hs = []
    for k in range(xw.shape[-2]):
        gates = xw[..., k, :] + h @ params["wh"]
        i, f, g, o = gates.split(HIDDEN, dim=-1)
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    hs = torch.stack(hs, dim=-2)
    return (hs @ params["w_out"] + params["b_out"])[..., 0]


def _logprob(logits, plan, available):
    """Paper Formula 12: Σ_{k ∈ V} log P(S_k | S_{k-1:1}; θ) — the sum runs
    over the SELECTED devices only (with n_sel << K the ~K unselected terms
    would swamp the selected ones and collapse the policy)."""
    logp = tnf.logsigmoid(logits)
    return torch.sum(torch.where(plan > 0, logp, 0.0) * available, dim=-1)


def _reinforce_grads(params, feats_batch, plans_batch, avail_batch,
                     advantages):
    """Mean REINFORCE gradient over N (plan, advantage) samples, with a
    small logit L2 that keeps the policy away from saturation."""
    with torch.enable_grad():
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        logits = _policy_logits(p, feats_batch)              # (N, K)
        lps = _logprob(logits, plans_batch, avail_batch)     # (N,)
        loss = (-torch.mean(lps * advantages)
                + 1e-2 * torch.mean(torch.square(logits)))
        grads = torch.autograd.grad(loss, list(p.values()))
    return dict(zip(p.keys(), grads))


def _probs(params, feats):
    with torch.no_grad():
        return torch.sigmoid(_policy_logits(params, feats))


@register_scheduler("rlds")
class RLDSScheduler(SchedulerBase):
    name = "rlds"

    def __init__(self, cost_model, seed: int = 0, lr: float = 1e-2,
                 epsilon: float = 0.1, gamma: float = 0.1,
                 pretrain_rounds: int = 300, pretrain_plans: int = 8,
                 search_backend: str = "fused"):
        # search_backend accepted (and ignored) for a uniform scheduler
        # constructor contract: RLDS has one policy-sampling path.
        super().__init__(cost_model, seed, search_backend=search_backend)
        self.epsilon = epsilon
        self.gamma = gamma  # EMA factor for the baseline b_m (paper Line 7)
        self.device = resolve_device(cost_model.device)
        self.params = init_policy(torch.Generator().manual_seed(seed),
                                  self.device)
        self._opt_init, self._opt_update = policy_optimizer(lr)
        self.opt_state = self._opt_init(self.params)
        # Baselines b_m start unset; the first observed reward initializes them.
        self.baselines = np.full(cost_model.pool.num_jobs, np.nan)
        self._adv_scale = 1.0  # running |advantage| normalizer
        # Pre-training is LAZY: the Algorithm-3 loop runs at the first
        # schedule() unless a warm start arrives first or pretrain_rounds == 0.
        self._pretrain_cfg = (pretrain_rounds, pretrain_plans)
        self._pretrained = pretrain_rounds <= 0

    # ---- persistence (policy zoo) ----

    def state_dict(self) -> Dict:
        """Full learner state: params and ``OptState`` as tensors, the
        rest numpy (``repro_torch.convert`` maps it to the reference's)."""
        return {
            "params": self.params,
            "opt": self.opt_state,
            "baselines": np.asarray(self.baselines, np.float64),
            "adv_scale": np.asarray(self._adv_scale, np.float64),
            "pretrained": np.asarray(self._pretrained),
        }

    def load_state_dict(self, tree: Dict) -> None:
        """Warm-start from a saved or trained state (tensor or numpy
        leaves; ``opt`` an ``OptState`` or a (step, (m, v)) pair). The
        pretrained flag rides in the state: a trained snapshot skips the
        lazy Algorithm-3 loop, a fresh one still pre-trains."""
        params = {k: as_tensor(v, self.device, torch.float32)
                  for k, v in tree["params"].items()}
        saved = {k: tuple(v.shape) for k, v in params.items()}
        own = {k: tuple(v.shape) for k, v in self.params.items()}
        if saved != own:
            raise ValueError(
                f"RLDS policy shapes {saved} do not match this build's "
                f"{own} (NUM_FEATURES/HIDDEN mismatch)")
        self.params = params
        step, inner = tree["opt"]
        self.opt_state = OptState(
            as_tensor(step, self.device, torch.int32),
            tree_map(lambda a: as_tensor(a, self.device, torch.float32),
                     tuple(inner)))
        baselines = np.array(tree["baselines"], np.float64)
        # Policies are portable across job mixes: a baseline vector saved
        # for a different M resets to unset.
        M = self.cost_model.pool.num_jobs
        self.baselines = baselines if baselines.shape == (M,) else np.full(M, np.nan)
        self._adv_scale = float(np.asarray(tree["adv_scale"]))
        self._pretrained = bool(np.asarray(tree["pretrained"]))

    # ---- dynamic job set (scheduler service) ----

    def ensure_jobs(self, num_jobs: int) -> None:
        """Grow the per-job baseline vector (params are shared across jobs)."""
        if num_jobs > self.baselines.shape[0]:
            pad = np.full(num_jobs - self.baselines.shape[0], np.nan)
            self.baselines = np.concatenate([self.baselines, pad])

    def job_state_dict(self, job: int) -> dict:
        return {"baseline": float(self.baselines[job])}

    def load_job_state(self, job: int, tree: dict) -> None:
        self.baselines[job] = float(tree["baseline"])

    # ---- features ----

    def _features(self, ctx: SchedulingContext) -> np.ndarray:
        pool = self.cost_model.pool
        t = ctx.expected_times
        f = np.stack([
            pool.a / pool.a.max(),
            pool.mu / pool.mu.max(),
            t / (t.max() + 1e-12),
            ctx.counts / (ctx.counts.max() + 1.0),
            ctx.available.astype(np.float64),
            pool.data_sizes[:, ctx.job] / pool.data_sizes.max(),
        ], axis=1)
        return f.astype(np.float32)

    def _t(self, a: np.ndarray) -> torch.Tensor:
        return h2d(np.asarray(a, np.float32), self.device)

    def _policy_probs(self, feats: np.ndarray) -> np.ndarray:
        return _probs(self.params, self._t(feats)).cpu().numpy()

    # ---- policy converter (ε-greedy) ----

    def _convert(self, probs: np.ndarray, ctx: SchedulingContext,
                 explore: bool) -> np.ndarray:
        """ε-greedy policy converter (paper Fig. 2).

        explore=True samples the plan from the policy itself via Gumbel top-k
        over the logits (Plackett-Luce without replacement), then applies the
        ε-greedy random swap on top. explore=False is the deterministic top-k.
        """
        K = ctx.available.shape[0]
        logits = np.log(np.clip(probs, 1e-9, 1 - 1e-9)) - np.log(
            np.clip(1 - probs, 1e-9, 1.0))
        if explore:
            plan = gumbel_topk_plans(self.rng, logits, ctx.available,
                                     ctx.n_sel)[0]
        else:
            score = np.where(ctx.available, logits, -np.inf)
            plan = np.zeros(K, dtype=bool)
            plan[np.argsort(-score, kind="stable")[: ctx.n_sel]] = True
        if explore:
            free = np.flatnonzero(ctx.available & ~plan)
            on = np.flatnonzero(plan)
            for k in on:
                if free.size and self.rng.random() < self.epsilon:
                    swap = self.rng.choice(free)
                    plan[k] = False
                    plan[swap] = True
                    free = np.flatnonzero(ctx.available & ~plan)
        return repair_plan(self.rng, plan, ctx.available, ctx.n_sel)

    # ---- Algorithm 2 ----

    def schedule(self, ctx: SchedulingContext) -> np.ndarray:
        if not self._pretrained:
            # Flag set only after _pretrain RETURNS: an exception mid-loop
            # (caller catches and retries) must not skip pre-training.
            self._pretrain(*self._pretrain_cfg)
            self._pretrained = True
        feats = self._features(ctx)
        probs = self._policy_probs(feats)
        # Annealed ε-greedy: exploration is front-loaded.
        eps_now = self.epsilon / (1.0 + ctx.round_idx / 50.0)
        old_eps, self.epsilon = self.epsilon, eps_now
        plan = self._convert(probs, ctx, explore=True)
        self.epsilon = old_eps
        self._last_feats = feats
        return self._score_plan(ctx, plan)

    def observe(self, ctx: SchedulingContext, plan: np.ndarray, realized_cost: float) -> None:
        reward = -realized_cost
        if np.isnan(self.baselines[ctx.job]):
            self.baselines[ctx.job] = reward
        adv = self._norm_adv(reward - self.baselines[ctx.job])
        self._update(
            feats=self._last_feats[None],
            plans=plan[None].astype(np.float32),
            avail=ctx.available[None].astype(np.float32),
            advantages=np.array([adv], np.float32),
        )
        self.baselines[ctx.job] = (
            (1 - self.gamma) * self.baselines[ctx.job] + self.gamma * reward)

    def _norm_adv(self, adv):
        """Running-scale advantage normalization (b_m centres, this bounds
        the magnitude)."""
        a = np.asarray(adv, np.float64)
        self._adv_scale = 0.95 * self._adv_scale + 0.05 * float(np.mean(np.abs(a)) + 1e-8)
        return a / max(self._adv_scale, 1e-6)

    def _update(self, feats, plans, avail, advantages):
        grads = _reinforce_grads(self.params, self._t(feats), self._t(plans),
                                 self._t(avail), self._t(advantages))
        updates, self.opt_state = self._opt_update(grads, self.opt_state,
                                                   self.params)
        self.params = tree_map(lambda p, u: p + u, self.params, updates)

    # ---- Algorithm 3: pre-training against the estimated cost model ----

    def _pretrain(self, rounds: int, n_plans: int) -> None:
        pool = self.cost_model.pool
        K, M = pool.num_devices, pool.num_jobs
        counts = np.zeros((M, K))
        n_sel = max(1, K // 10)
        for r in range(rounds):
            m = r % M
            tau = 5.0
            ctx = SchedulingContext(
                job=m, round_idx=r, tau=tau, n_sel=n_sel,
                available=np.ones(K, dtype=bool), counts=counts[m],
                expected_times=pool.expected_times(m, tau))
            feats = self._features(ctx)
            probs = self._policy_probs(feats)
            plans = np.stack([self._convert(probs, ctx, explore=True)
                              for _ in range(n_plans)])
            costs = self._own_cost_of(ctx, plans)
            rewards = -costs
            if np.isnan(self.baselines[m]):
                self.baselines[m] = float(rewards.mean())
            # Batch standardization (on top of the EMA baseline).
            adv = rewards - rewards.mean()
            adv = adv / (adv.std() + 1e-8)
            self._update(
                feats=np.repeat(feats[None], n_plans, 0),
                plans=plans.astype(np.float32),
                avail=np.repeat(ctx.available[None].astype(np.float32), n_plans, 0),
                advantages=adv.astype(np.float32),
            )
            self.baselines[m] = ((1 - self.gamma) * self.baselines[m]
                                 + self.gamma * float(rewards.mean()))
            best = plans[int(np.argmin(costs))]
            counts[m] += best
