"""Batched REINFORCE over the scheduler gym (the scalable Algorithm 3).

Replaces RLDS's sequential constructor pre-training loop: instead of 300
Python rounds against one fixed pool, the trainer runs E batched
environments with independently randomized scenarios, collects E*T
scheduling decisions per iteration, and updates the policy with the same
REINFORCE gradient the live scheduler uses (``rlds._reinforce_grads`` — one
gradient path, offline and online):

    rollout (E envs x T rounds)  ->  EMA-baseline advantages (per job,
    batch-standardized)          ->  shuffled minibatched AdamW updates.

Curriculum stages with different pool sizes cycle in the outer loop (every
environment of a batch has the same K); everything else — heterogeneity,
failure rate, job mix — varies per environment inside a single batch via
``ScenarioSpec`` sampling.

One iteration is ``train_iter(params, opt_state, baselines, draws)``: its
random inputs (the scenarios, the rollout noise, the minibatch permutation)
come in as ``IterDraws``, drawn by ``draw_iter`` from a ``torch.Generator``
on the trainer's device, so a test can hand it the reference's draws.

The trained params drop directly into ``RLDSScheduler`` (same policy
network, same feature map) through the policy zoo + the ExperimentSpec
``policy`` axis.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, NamedTuple, Sequence, Tuple

import torch

from repro_torch.core.schedulers.rlds import (_reinforce_grads, init_policy,
                                              policy_optimizer)
from repro_torch.core.scoring import resolve_device
from repro_torch.gym.env import (EnvConfig, Noise, batch_rollout, draw_noise,
                                 state_from_draw)
from repro_torch.gym.scenarios import (CURRICULA, ScenarioDraw, ScenarioSpec,
                                       sample_scenario)
from repro_torch.tree import tree_map


class TrainConfig(NamedTuple):
    """Trainer knobs."""

    num_envs: int = 32       # E parallel environments per iteration
    rollout_len: int = 32    # T rounds per environment per iteration
    iters: int = 80          # total iterations (across all stages)
    lr: float = 1e-2
    gamma: float = 0.1       # EMA factor for the per-job baselines b_m
    minibatches: int = 4     # gradient steps per iteration


Stage = Tuple[EnvConfig, ScenarioSpec]


class IterDraws(NamedTuple):
    """The random inputs of one training iteration."""

    scenario: ScenarioDraw   # E scenarios
    noise: Noise             # 5 x (E, T, K) rollout draws
    perm: torch.Tensor       # (E*T,) int64 permutation of the batch


def default_stages(curriculum: str = "default",
                   num_devices: Sequence[int] = (64,), num_jobs: int = 3,
                   n_sel_frac: float = 0.1, alpha: float = 4.0,
                   beta: float = 0.25) -> List[Stage]:
    """Curriculum stages: one (EnvConfig, ScenarioSpec) per pool size."""
    scen = CURRICULA[curriculum]
    return [(EnvConfig(num_devices=int(K), num_jobs=num_jobs,
                       n_sel=max(1, int(round(n_sel_frac * K))),
                       alpha=alpha, beta=beta), scen)
            for K in num_devices]


def draw_iter(cfg: EnvConfig, scen: ScenarioSpec, tcfg: TrainConfig,
              generator: torch.Generator, device) -> IterDraws:
    """One iteration's scenarios, rollout noise and permutation."""
    E, T, K = tcfg.num_envs, tcfg.rollout_len, cfg.num_devices
    d = sample_scenario(generator, scen, K, cfg.num_jobs, E, device)
    noise = draw_noise(generator, (E, T, K), device)
    perm = torch.randperm(E * T, generator=generator, device=device)
    return IterDraws(d, noise, perm)


def make_train_iter(cfg: EnvConfig, scen: ScenarioSpec, tcfg: TrainConfig,
                    opt_update: Callable):
    """One training iteration for a fixed stage."""
    E, T, M = tcfg.num_envs, tcfg.rollout_len, cfg.num_jobs
    B = E * T
    nb = max(1, min(tcfg.minibatches, B))
    mb = B // nb

    def train_iter(params, opt_state, baselines, draws: IterDraws):
        states = state_from_draw(cfg, scen, draws.scenario)
        _, tr = batch_rollout(cfg, params, states, T, noise=draws.noise)

        # Per-job EMA baselines (paper Line 7), batch-standardized advantages
        # (kills the reward/gradient-magnitude correlation, as in _pretrain).
        rewards = tr.reward                                    # (E, T)
        onehot = (tr.job[..., None] == torch.arange(
            M, device=tr.job.device)).to(rewards.dtype)      # (E, T, M)
        per_job_n = torch.clamp(onehot.sum((0, 1)), min=1.0)
        per_job_mean = torch.einsum("et,etm->m", rewards, onehot) / per_job_n
        baselines = torch.where(torch.isnan(baselines), per_job_mean,
                                baselines)
        adv = rewards - baselines[tr.job]
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        new_baselines = ((1 - tcfg.gamma) * baselines
                         + tcfg.gamma * per_job_mean)

        # Shuffled minibatched updates over the flattened batch.
        feats = tr.feats.reshape(B, cfg.num_devices, -1)
        plans = tr.plan.reshape(B, -1).to(torch.float32)
        avail = tr.available.reshape(B, -1).to(torch.float32)
        advf = adv.reshape(B)
        idx = draws.perm[: nb * mb].reshape(nb, mb)
        for i in idx:
            grads = _reinforce_grads(params, feats[i], plans[i], avail[i],
                                     advf[i])
            updates, opt_state = opt_update(grads, opt_state, params)
            params = tree_map(lambda a, u: a + u, params, updates)
        log = {"mean_cost": tr.cost.mean(), "mean_reward": rewards.mean(),
               "mean_round_time": tr.round_time.mean()}
        return params, opt_state, new_baselines, log

    return train_iter


def train_rlds(stages: Sequence[Stage], tcfg: TrainConfig = TrainConfig(),
               seed: int = 0, params=None, device="cuda"
               ) -> Tuple[Dict, List[Dict[str, float]]]:
    """Train an RLDS policy over curriculum ``stages`` (cycled round-robin)
    on ``device``.

    Returns (trained params, per-iteration logs). ``params=None`` starts
    from a fresh ``init_policy`` draw (a CPU ``torch.Generator`` seeded by
    ``seed``); passing existing params fine-tunes. The iterations' draws
    come from a generator on ``device`` seeded by ``seed``.
    """
    dev = resolve_device(device)
    if params is None:
        params = init_policy(torch.Generator().manual_seed(seed), dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    opt_init, opt_update = policy_optimizer(tcfg.lr)
    opt_state = opt_init(params)

    iters = [make_train_iter(cfg, scen, tcfg, opt_update)
             for cfg, scen in stages]
    # Baselines are per (stage-M); costs are scale-calibrated so one EMA
    # vector per job count is meaningful across scenarios.
    baselines = {i: torch.full((cfg.num_jobs,), torch.nan, device=dev)
                 for i, (cfg, _) in enumerate(stages)}

    logs: List[Dict[str, float]] = []
    for it in range(tcfg.iters):
        si = it % len(stages)
        cfg, scen = stages[si]
        t0 = time.perf_counter()
        draws = draw_iter(cfg, scen, tcfg, gen, dev)
        params, opt_state, baselines[si], log = iters[si](
            params, opt_state, baselines[si], draws)
        log = {k: float(v) for k, v in log.items()}   # waits for the device
        logs.append({"iter": it, "stage": si, **log,
                     "wall_s": time.perf_counter() - t0})
    return params, logs


def evaluate(cfg: EnvConfig, scen: ScenarioSpec, params, seed: int = 0,
             episodes: int = 32, steps: int = 32,
             deterministic: bool = True, device="cuda") -> Dict[str, float]:
    """Mean per-round cost/round-time of a policy over fresh scenarios.

    Deterministic (greedy top-k: zero Gumbel noise) by default so
    trained-vs-untrained comparisons at the same seed are paired on
    identical scenario draws.
    """
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d = sample_scenario(gen, scen, cfg.num_devices, cfg.num_jobs, episodes,
                        dev)
    noise = draw_noise(gen, (episodes, steps, cfg.num_devices), dev,
                   gumbel=not deterministic)
    params = tree_map(lambda p: p.to(dev), params)
    _, tr = batch_rollout(cfg, params, state_from_draw(cfg, scen, d), steps,
                          noise=noise)
    return {"mean_cost": float(tr.cost.mean()),
            "mean_round_time": float(tr.round_time.mean()),
            "episodes": episodes, "steps": steps}
