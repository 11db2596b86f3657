"""Batched multi-job scheduling environment (the scheduler gym).

The live ``MultiJobEngine`` is an event-driven Python loop — correct, but
useless for training learned schedulers at scale: RLDS pre-training needs
millions of scheduling decisions over DIVERSE scenarios, and a Python
round loop delivers thousands. This module is the trainable mirror of the
engine: the whole environment state is a NamedTuple of tensors with a
leading environment axis E on one device, and every function steps all E
environments at once. A rollout is a Python loop over its T rounds.

Semantics mirror ``repro_torch.core.multijob.MultiJobEngine`` (and the
reference's ``repro.gym.env``; both parity-tested in
tests/test_torch_gym.py):

- **Time model** — Formula 4 shifted-exponential realized times, identical
  coefficients to ``DevicePool`` (``t = tau*D*a + Exp(tau*D/mu)``); like the
  pool's SoA fast path, the per-job shift/scale products are materialized
  ONCE at reset so the per-step work is one multiply-add.
- **Occupancy** — each scheduled device is busy until ITS OWN finish time;
  a job launches its next round at ``max(own release instant, instant at
  which n_sel devices are free)`` — exactly the engine's retry-until-release
  behaviour, computed in closed form from the n_sel-th smallest
  ``busy_until``.
- **Faults** — each scheduled device drops with ``failure_rate``; survivors
  define the round time, failed devices are quarantined for
  ``failure_cooldown`` and excluded from the fairness-count update, and the
  engine's keep-one guard applies when everyone fails.
- **Cost** — Formula 2/3 evaluated through the scoring core's reductions
  (``repro_torch.core.scoring.fairness_dense`` / ``round_time_dense``, one
  batch row per environment): realized straggler max + fairness-variance
  increment, normalized by the calibrated time/fairness scales.

Jobs are scheduled round-robin (the engine interleaves by completion
events; round-robin is the synchronous projection of that order and keeps
every environment in step). Per-device policy features mirror
``RLDSScheduler._features`` field for field, so a gym-trained policy drops
into the live scheduler unchanged.

All randomness comes from an explicit ``torch.Generator`` on the
environment's device; the state carries none. Rollouts draw the whole
trajectory's noise in bulk (five (E, T, K) tensors) before the loop, or take
it pre-drawn through ``noise=`` (the parity tests inject the reference's).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import scoring
from repro_torch.gym.scenarios import ScenarioSpec, sample_scenario

Noise = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
              torch.Tensor]


class EnvConfig(NamedTuple):
    """Static environment shape/coefficients; everything per-scenario lives
    in ``EnvState``."""

    num_devices: int = 64
    num_jobs: int = 3
    n_sel: int = 6
    alpha: float = 4.0
    beta: float = 0.25
    # Cost fairness form, mirroring CostModel.delta_fairness: True uses the
    # per-round increment Var(c+v) - Var(c), False the absolute Formula-5
    # variance (the engine honors the same flag in its realized cost).
    delta_fairness: bool = True
    failure_cooldown: float = 60.0


class Scenario(NamedTuple):
    """Per-episode coefficients of E environments, drawn at reset and fixed
    until the next.

    Beyond the raw Formula-4 parameters, the scenario carries the
    derived arrays every step would otherwise recompute (mirroring
    ``DevicePool``'s structure-of-arrays fast path): per-job realized-time
    ``shift``/``scale``, per-job expected times ``exp_base``, and the
    max-normalized static policy features.
    """

    a: torch.Tensor               # (E, K) capability floor
    mu: torch.Tensor              # (E, K) fluctuation rate
    data: torch.Tensor            # (E, K, M) per-job data sizes
    taus: torch.Tensor            # (E, M) local epochs (job mix)
    failure_rate: torch.Tensor    # (E,) per-device drop probability
    time_scale: torch.Tensor      # (E,) calibrated Formula-2 normalizers
    fairness_scale: torch.Tensor  # (E,)
    shift: torch.Tensor           # (E, M, K) tau*D*a   (realized-time floor)
    scale: torch.Tensor           # (E, M, K) tau*D/mu  (exponential scale)
    exp_base: torch.Tensor        # (E, M, K) expected times tau*D*(a + 1/mu)
    a_norm: torch.Tensor          # (E, K) a / max(a)        (policy features)
    mu_norm: torch.Tensor         # (E, K) mu / max(mu)
    data_norm: torch.Tensor       # (E, K, M) D / max(D)
    # Online-traffic windows (global env steps): job m is live while
    # job_start[m] <= t < job_end[m]; the closed-job-set default is
    # start=0 / end=inf for every job.
    job_start: torch.Tensor       # (E, M)
    job_end: torch.Tensor         # (E, M)
    # Rich fault axes (inert at the zero defaults): per-round straggler
    # slowdowns and correlated fault-domain outages, mirroring the live
    # engine's ``repro_torch.faults`` schedule.
    straggler_rate: torch.Tensor      # (E,) per-device slowdown probability
    straggler_slowdown: torch.Tensor  # (E,) compute-time multiplier
    domain: torch.Tensor              # (E, K) int64 fault-domain assignment
    domain_rate: torch.Tensor         # (E,) per-round whole-domain outage prob


class EnvState(NamedTuple):
    """E environments: scenario + dynamic clocks/counters."""

    scen: Scenario
    busy_until: torch.Tensor   # (E, K) occupancy clocks
    counts: torch.Tensor       # (E, M, K) fairness counters s_{k,m}
    round_idx: torch.Tensor    # (E, M) int32 per-job round indices
    job_clock: torch.Tensor    # (E, M) per-job release instants
    job: torch.Tensor          # (E,) int64 job scheduled at the next step
    t: torch.Tensor            # (E,) int64 global step counter


class StepOut(NamedTuple):
    """Per-step outcome of each environment (the quantities the engine
    records per round), each (E,)."""

    cost: torch.Tensor        # realized Formula-2 cost (delta fairness)
    round_time: torch.Tensor  # realized Formula-3 straggler max
    fairness: torch.Tensor    # absolute Formula-5 variance (recorded form)
    dfair: torch.Tensor       # fairness increment used in the cost
    reward: torch.Tensor      # -cost (the RLDS reward)
    job: torch.Tensor         # job index that was scheduled
    now: torch.Tensor         # launch instant


class Transition(NamedTuple):
    """What a policy rollout collects per step (REINFORCE ingredients);
    stacked (E, T, ...) by the rollouts."""

    feats: torch.Tensor      # (K, F) policy features
    plan: torch.Tensor       # (K,) bool
    available: torch.Tensor  # (K,) bool
    reward: torch.Tensor
    cost: torch.Tensor
    round_time: torch.Tensor
    job: torch.Tensor


def _rows(x: torch.Tensor, job: torch.Tensor) -> torch.Tensor:
    """``x[e, job[e]]`` for each environment e: (E, M, ...) -> (E, ...)."""
    return x[torch.arange(x.shape[0], device=x.device), job]


def _median(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Median along ``dim`` as ``jnp.median`` takes it: the mean of the two
    middle values at an even length (``torch.median`` returns the lower)."""
    s = torch.sort(x, dim=dim).values
    n = s.shape[dim]
    lo = s.narrow(dim, (n - 1) // 2, 1)
    hi = s.narrow(dim, n // 2, 1)
    return (0.5 * lo + 0.5 * hi).squeeze(dim)


# ---- reset ---------------------------------------------------------------

def calibrate_scales(cfg: EnvConfig, exp_base: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mirror ``CostModel.calibrate`` per environment: time_scale = median
    over jobs of the median of the n_sel smallest expected times;
    fairness_scale = p(1-p). ``exp_base`` (E, M, K) -> two (E,) tensors."""
    fastest = torch.sort(exp_base, dim=-1).values[..., : cfg.n_sel]
    time_scale = torch.clamp(_median(_median(fastest, -1), -1), min=1e-9)
    p = cfg.n_sel / cfg.num_devices
    fairness_scale = torch.full_like(time_scale,
                                     float(np.float32(max(p * (1.0 - p),
                                                          1e-6))))
    return time_scale, fairness_scale


def _f32(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _per_env(x, E: int, device) -> torch.Tensor:
    """A scalar or (E,) coefficient as an (E,) f32 tensor."""
    return _f32(x, device).expand(E).contiguous()


def make_scenario(cfg: Optional[EnvConfig], a, mu, data, taus, failure_rate,
                  time_scale=None, fairness_scale=None,
                  job_start=None, job_end=None,
                  straggler_rate=0.0, straggler_slowdown=3.0,
                  domain=None, domain_rate=0.0, device="cuda") -> Scenario:
    """Materialize the derived per-job arrays (SoA fast path) and calibrate
    the cost normalizers (unless given, e.g. from a live CostModel — then
    ``cfg`` may be None). ``a``, ``mu`` (E, K), ``data`` (E, K, M) and
    ``taus`` (E, M) lead with the environment axis; the per-episode scalars
    are (E,) or one value for all. The fault axes default to inert (no
    stragglers, no fault domains)."""
    a, mu, data, taus = (_f32(x, device) for x in (a, mu, data, taus))
    E, K, M = data.shape
    d_t = data.transpose(1, 2)                      # (E, M, K)
    shift = taus[:, :, None] * d_t * a[:, None, :]
    scale = taus[:, :, None] * d_t / mu[:, None, :]
    exp_base = shift + scale                        # tau*D*(a + 1/mu)
    if time_scale is None or fairness_scale is None:
        time_scale, fairness_scale = calibrate_scales(cfg, exp_base)
    if job_start is None:
        job_start = torch.zeros((E, M), device=device)
    if job_end is None:
        job_end = torch.full((E, M), torch.inf, device=device)
    if domain is None:
        domain = torch.zeros((E, K), dtype=torch.int64, device=device)
    return Scenario(
        a=a, mu=mu, data=data, taus=taus,
        failure_rate=_per_env(failure_rate, E, device),
        time_scale=_per_env(time_scale, E, device),
        fairness_scale=_per_env(fairness_scale, E, device),
        shift=shift, scale=scale, exp_base=exp_base,
        a_norm=a / a.amax(-1, keepdim=True),
        mu_norm=mu / mu.amax(-1, keepdim=True),
        data_norm=data / data.amax((1, 2), keepdim=True),
        job_start=_f32(job_start, device), job_end=_f32(job_end, device),
        straggler_rate=_per_env(straggler_rate, E, device),
        straggler_slowdown=_per_env(straggler_slowdown, E, device),
        domain=torch.as_tensor(domain, device=device).to(torch.int64),
        domain_rate=_per_env(domain_rate, E, device))


def _zero_dynamics(cfg: EnvConfig, scen: Scenario) -> EnvState:
    """``scen``'s environments at step 0: idle devices, zero counts."""
    E, K, M = scen.data.shape
    dev = scen.a.device
    return EnvState(
        scen=scen,
        busy_until=torch.zeros((E, K), device=dev),
        counts=torch.zeros((E, M, K), device=dev),
        round_idx=torch.zeros((E, M), dtype=torch.int32, device=dev),
        job_clock=torch.zeros((E, M), device=dev),
        job=torch.zeros((E,), dtype=torch.int64, device=dev),
        t=torch.zeros((E,), dtype=torch.int64, device=dev))


def state_from_draw(cfg: EnvConfig, scen_spec: ScenarioSpec, d) -> EnvState:
    """Zeroed environments over the scenarios of a ``ScenarioDraw``."""
    scen = make_scenario(cfg, d.a, d.mu, d.data, d.taus, d.failure_rate,
                         job_start=d.job_start, job_end=d.job_end,
                         straggler_rate=d.straggler_rate,
                         straggler_slowdown=scen_spec.straggler_slowdown,
                         domain=d.domain, domain_rate=d.domain_rate,
                         device=d.a.device)
    return _zero_dynamics(cfg, scen)


def batch_reset(cfg: EnvConfig, scen_spec: ScenarioSpec,
                generator: torch.Generator, num_envs: int,
                device="cuda") -> EnvState:
    """E independent randomized scenarios with zeroed dynamics."""
    d = sample_scenario(generator, scen_spec, cfg.num_devices, cfg.num_jobs,
                        num_envs, device)
    return state_from_draw(cfg, scen_spec, d)


def reset(cfg: EnvConfig, scen_spec: ScenarioSpec,
          generator: torch.Generator, device="cuda") -> EnvState:
    """One fresh randomized scenario (a batch of E = 1)."""
    return batch_reset(cfg, scen_spec, generator, 1, device)


def state_from_pool(pool, cost_model, taus: Sequence[float],
                    failure_rate: float = 0.0, device="cuda") -> EnvState:
    """EnvState (E = 1) mirroring a CONCRETE ``DevicePool`` + calibrated
    ``CostModel`` — the bridge for engine-parity tests and for training a
    policy against the exact scenario an ``ExperimentSpec`` will run."""
    K, M = pool.num_devices, pool.num_jobs
    if len(taus) != M:
        raise ValueError(f"{len(taus)} taus for {M} jobs")
    scen = make_scenario(None, pool.a[None], pool.mu[None],
                         pool.data_sizes[None], np.asarray(taus)[None],
                         failure_rate, time_scale=cost_model.time_scale,
                         fairness_scale=cost_model.fairness_scale,
                         device=device)
    return _zero_dynamics(config_from_cost_model(cost_model, n_sel=1),
                          scen)


def config_from_cost_model(cost_model, n_sel: int,
                           failure_cooldown: float = 60.0) -> EnvConfig:
    """EnvConfig matching a live CostModel's pool and coefficients; pass
    the engine's ``failure_cooldown`` so quarantine dynamics match too."""
    return EnvConfig(num_devices=cost_model.pool.num_devices,
                     num_jobs=cost_model.pool.num_jobs, n_sel=n_sel,
                     alpha=float(cost_model.alpha),
                     beta=float(cost_model.beta),
                     delta_fairness=bool(cost_model.delta_fairness),
                     failure_cooldown=float(failure_cooldown))


# ---- step ----------------------------------------------------------------

def release_instant(cfg: EnvConfig, state: EnvState) -> torch.Tensor:
    """Engine retry semantics in closed form: the job launches at
    ``max(its own release instant, the instant n_sel devices are free)``
    (the n_sel-th smallest occupancy clock). (E,)"""
    kth_free = torch.kthvalue(state.busy_until, cfg.n_sel, dim=-1).values
    return torch.maximum(_rows(state.job_clock, state.job), kth_free)


def available_mask(state: EnvState, now: torch.Tensor) -> torch.Tensor:
    return state.busy_until <= now[:, None] + 1e-6


def job_active(state: EnvState) -> torch.Tensor:
    """(E,) bool — is the job up for scheduling live at the current step?
    (Online-traffic windows; always True under the closed-set default.)
    Rollouts AND this into the plan: an inactive job's round is an empty
    plan, which ``_apply_round`` treats as a zero-cost, zero-time no-op
    (and an empty plan has zero REINFORCE log-prob, so inactive rounds
    contribute no gradient)."""
    t = state.t.to(torch.float32)
    return ((_rows(state.scen.job_start, state.job) <= t)
            & (t < _rows(state.scen.job_end, state.job)))


def _apply_round(cfg: EnvConfig, state: EnvState, plan: torch.Tensor,
                 exp_noise: torch.Tensor, fail_u: torch.Tensor,
                 straggler_u: Optional[torch.Tensor] = None,
                 domain_u: Optional[torch.Tensor] = None
                 ) -> Tuple[EnvState, StepOut]:
    """Deterministic round transition of E environments given the
    stochastic draws.

    ``plan``: (E, K) bool; ``exp_noise``: (E, K) unit-exponential draws
    (Formula 4's jitter); ``fail_u``: (E, K) uniforms for the fault
    coin-flips. Exposed separately so rollouts can pre-draw whole
    trajectories in bulk and so the engine-parity test can inject the exact
    draws the live ``DevicePool``/engine consumed.

    The rich-fault draws are optional (None skips them): ``straggler_u``
    (E, K) uniforms gating the per-device slowdown multiplier; ``domain_u``
    (E, K) uniforms read PER FAULT DOMAIN — each device reads the uniform
    of its domain, so the outage coin-flip is shared by every device in a
    domain, mirroring ``repro_torch.faults.FaultEngine``.
    """
    scen = state.scen
    job = state.job
    E = job.shape[0]
    now = release_instant(cfg, state)

    # Formula 4 realized times from the precomputed per-job shift/scale
    # (selected devices are available => no wait term).
    times = _rows(scen.shift, job) + exp_noise * _rows(scen.scale, job)
    if straggler_u is not None:
        times = times * torch.where(straggler_u < scen.straggler_rate[:, None],
                                    scen.straggler_slowdown[:, None], 1.0)

    sel = plan
    fail = sel & (fail_u < scen.failure_rate[:, None])
    if domain_u is not None:
        # One uniform per domain, gathered per device: the whole domain
        # shares a coin-flip, so outages are correlated.
        outage = torch.gather(domain_u, -1, scen.domain)
        fail = fail | (sel & (outage < scen.domain_rate[:, None]))
    survivors = sel & ~fail
    # Engine guard: if every selected device failed, keep the first one
    # (argmax returns the first maximum; a comparison with an arange in
    # place of one_hot, which checks its input's range on the host).
    first = torch.argmax(sel.to(torch.int8), dim=-1)
    devices = torch.arange(cfg.num_devices, device=sel.device)
    first_sel = (devices == first[:, None]) & sel
    survivors = torch.where(survivors.any(-1, keepdim=True), survivors,
                            first_sel)
    fail = sel & ~survivors

    # Formula 3 via the scoring core's masked-max reduction.
    round_time = scoring.round_time_dense(times, survivors[:, None, :])[:, 0]
    t_end = now + round_time

    busy = torch.where(sel, now[:, None] + times, state.busy_until)
    busy = torch.where(fail, (t_end + cfg.failure_cooldown)[:, None],
                       busy)                        # quarantine

    # Formula 2/5 via the scoring core. Counts are mean-centered (f32-safe
    # variance); the absolute Formula-5 value recorded by the engine is the
    # increment plus Var(c) = E[c_centered^2]. The cost term uses the
    # increment or the absolute form per cfg.delta_fairness, exactly as the
    # engine's realized cost does.
    counts_j = _rows(state.counts, job)
    counts_c = counts_j - counts_j.mean(-1, keepdim=True)
    dfair = scoring.fairness_dense(counts_c, plan[:, None, :], True)[:, 0]
    fairness = dfair + torch.square(counts_c).mean(-1)
    cost_fair = dfair if cfg.delta_fairness else fairness
    cost = (cfg.alpha * round_time / scen.time_scale
            + cfg.beta * cost_fair / scen.fairness_scale)

    env = torch.arange(E, device=job.device)
    counts = state.counts.clone()
    counts[env, job] += survivors.to(torch.float32)
    round_idx = state.round_idx.clone()
    round_idx[env, job] += 1
    job_clock = state.job_clock.clone()
    job_clock[env, job] = t_end
    new_state = state._replace(
        busy_until=busy, counts=counts, round_idx=round_idx,
        job_clock=job_clock, job=(job + 1) % cfg.num_jobs, t=state.t + 1)
    out = StepOut(cost=cost, round_time=round_time, fairness=fairness,
                  dfair=dfair, reward=-cost, job=job, now=now)
    return new_state, out


def _exponential(generator: torch.Generator, shape, device) -> torch.Tensor:
    return torch.empty(shape, device=device).exponential_(generator=generator)


def draw_noise(generator: torch.Generator, shape, device,
               gumbel: bool = True) -> Noise:
    """Unit exponentials, fault uniforms, Gumbels (-log of a unit
    exponential; zeros if not ``gumbel``), straggler and domain uniforms,
    each of ``shape``."""
    def u():
        return torch.rand(shape, generator=generator, device=device)

    exp = _exponential(generator, shape, device)
    fail = u()
    gum = (-torch.log(_exponential(generator, shape, device)) if gumbel
           else torch.zeros(shape, device=device))
    return exp, fail, gum, u(), u()


def step(cfg: EnvConfig, state: EnvState, plan: torch.Tensor,
         generator: torch.Generator) -> Tuple[EnvState, StepOut]:
    """One scheduling round of each environment's round-robin job under
    ``plan`` ((E, K) bool, exactly n_sel available devices each)."""
    exp_noise, fail_u, _, straggler_u, domain_u = draw_noise(
        generator, state.busy_until.shape, state.busy_until.device,
        gumbel=False)
    return _apply_round(cfg, state, plan, exp_noise, fail_u, straggler_u,
                        domain_u)


# ---- policy plumbing (mirrors RLDSScheduler) -----------------------------

def device_features(cfg: EnvConfig, state: EnvState, now: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(E, K, F) per-device policy features + (E, K) availability mask.

    Field-for-field mirror of ``RLDSScheduler._features`` (keep in sync):
    [a, mu, E[t]+wait (job-specific), fairness count, availability, D^m].
    The scenario-constant normalizations are precomputed at reset.
    """
    scen = state.scen
    job = state.job
    wait = torch.clamp(state.busy_until - now[:, None], min=0.0)
    available = available_mask(state, now)
    exp_t = _rows(scen.exp_base, job) + wait
    counts = _rows(state.counts, job)
    env = torch.arange(job.shape[0], device=job.device)
    feats = torch.stack([
        scen.a_norm,
        scen.mu_norm,
        exp_t / (exp_t.amax(-1, keepdim=True) + 1e-12),
        counts / (counts.amax(-1, keepdim=True) + 1.0),
        available.to(torch.float32),
        scen.data_norm[env, :, job],
    ], dim=-1)
    return feats, available


def _top_plan(score: torch.Tensor, available: torch.Tensor,
              n_sel: int) -> torch.Tensor:
    idx = torch.topk(score, n_sel, dim=-1).indices
    plan = torch.zeros_like(available).scatter_(-1, idx, True)
    return plan & available


def plan_from_gumbel(logits: torch.Tensor, gumbel: torch.Tensor,
                     available: torch.Tensor, n_sel: int) -> torch.Tensor:
    """Gumbel top-k plan from pre-drawn Gumbel noise (Plackett-Luce without
    replacement over the available set); (..., K) in, (..., K) bool out.

    Precondition: ``available.sum(-1) >= n_sel`` (``release_instant``
    guarantees it inside rollouts). The result is post-masked with
    ``available``: a violating caller gets a SMALLER plan (caught by
    ``validate_plan``), never a plan that schedules busy devices. Ties can
    fall only among the ``-inf`` entries of busy devices, which that mask
    removes.
    """
    return _top_plan(torch.where(available, logits + gumbel, -torch.inf),
                     available, n_sel)


def sample_plan(generator: torch.Generator, logits: torch.Tensor,
                available: torch.Tensor, n_sel: int) -> torch.Tensor:
    """On-policy Gumbel top-k plan — the policy-converter sampling RLDS
    uses, minus the host-side ε-swap (Gumbel noise already provides proper
    visitation)."""
    gumbel = -torch.log(_exponential(generator, logits.shape, logits.device))
    return plan_from_gumbel(logits, gumbel, available, n_sel)


def greedy_plan(logits: torch.Tensor, available: torch.Tensor, n_sel: int
                ) -> torch.Tensor:
    """Deterministic top-k (the explore=False policy converter). Same
    ``available.sum(-1) >= n_sel`` precondition and post-mask as
    ``plan_from_gumbel``."""
    return _top_plan(torch.where(available, logits, -torch.inf), available,
                     n_sel)


def _rollout_noise(state: EnvState, num_steps: int,
                   generator: Optional[torch.Generator],
                   noise: Optional[Noise], gumbel: bool) -> Noise:
    if noise is not None:
        return noise
    if generator is None:
        raise ValueError("a rollout needs a generator or pre-drawn noise")
    E, K = state.busy_until.shape
    return draw_noise(generator, (E, num_steps, K), state.busy_until.device,
                  gumbel=gumbel)


def _stack(rows, cls):
    return cls(*(torch.stack(f, dim=1) for f in zip(*rows)))


@torch.no_grad()
def policy_rollout(cfg: EnvConfig, params, state: EnvState, num_steps: int,
                   deterministic: bool = False,
                   generator: Optional[torch.Generator] = None,
                   noise: Optional[Noise] = None
                   ) -> Tuple[EnvState, Transition]:
    """The RLDS policy over ``num_steps`` rounds of every environment.

    Returns the final state and an (E, num_steps)-stacked ``Transition`` —
    the REINFORCE ingredients (features/plan/availability for the log-prob,
    reward for the advantage). ``noise`` is the trajectory's draws
    ``(exp, fail_u, gumbel, straggler_u, domain_u)``, each (E, T, K); without
    it they are drawn from ``generator`` in bulk (``deterministic`` draws
    no Gumbels: the plan is the greedy top-k).
    """
    from repro_torch.core.schedulers.rlds import _policy_logits

    exp, fail_u, gumbel, straggler_u, domain_u = _rollout_noise(
        state, num_steps, generator, noise, not deterministic)
    rows = []
    for i in range(num_steps):
        now = release_instant(cfg, state)
        feats, available = device_features(cfg, state, now)
        logits = _policy_logits(params, feats)
        plan = plan_from_gumbel(logits, gumbel[:, i], available, cfg.n_sel)
        plan = plan & job_active(state)[:, None]
        state, out = _apply_round(cfg, state, plan, exp[:, i], fail_u[:, i],
                                  straggler_u[:, i], domain_u[:, i])
        rows.append(Transition(feats=feats, plan=plan, available=available,
                               reward=out.reward, cost=out.cost,
                               round_time=out.round_time, job=out.job))
    return state, _stack(rows, Transition)


def batch_rollout(cfg: EnvConfig, params, states: EnvState, num_steps: int,
                  deterministic: bool = False,
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[Noise] = None
                  ) -> Tuple[EnvState, Transition]:
    """``policy_rollout`` over E environments (every function here is
    batched over E): transitions come back (E, num_steps, ...)."""
    return policy_rollout(cfg, params, states, num_steps, deterministic,
                          generator, noise)


@torch.no_grad()
def random_rollout(cfg: EnvConfig, state: EnvState, num_steps: int,
                   generator: Optional[torch.Generator] = None,
                   noise: Optional[Noise] = None
                   ) -> Tuple[EnvState, StepOut]:
    """Uniform-random-plan rollout (no policy): the env-only throughput
    workload and the random-scheduler baseline. Identical environment
    machinery to ``policy_rollout`` minus the policy network; ``StepOut``
    comes back (E, num_steps)."""
    exp, fail_u, gumbel, straggler_u, domain_u = _rollout_noise(
        state, num_steps, generator, noise, True)
    rows = []
    for i in range(num_steps):
        now = release_instant(cfg, state)
        available = available_mask(state, now)
        plan = plan_from_gumbel(torch.zeros_like(gumbel[:, i]), gumbel[:, i],
                                available, cfg.n_sel)
        plan = plan & job_active(state)[:, None]
        state, out = _apply_round(cfg, state, plan, exp[:, i], fail_u[:, i],
                                  straggler_u[:, i], domain_u[:, i])
        rows.append(out)
    return state, _stack(rows, StepOut)


def batch_random_rollout(cfg: EnvConfig, states: EnvState, num_steps: int,
                         generator: Optional[torch.Generator] = None,
                         noise: Optional[Noise] = None
                         ) -> Tuple[EnvState, StepOut]:
    return random_rollout(cfg, states, num_steps, generator, noise)
