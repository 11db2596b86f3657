"""Scenario randomization and curricula for the scheduler gym.

A ``ScenarioSpec`` is a static description of the DISTRIBUTION a gym
environment draws its episode from: capability heterogeneity, device
fluctuation, data-size spread, job mix (local epochs), and failure rate.
``sample_scenario`` draws E concrete scenarios at once, one per parallel
environment, so a single training batch spans the whole curriculum.

Pool-SIZE diversity is the one axis that cannot vary inside a batch (every
environment of a batch has K devices); the trainer handles it by cycling
through curriculum STAGES with different ``EnvConfig.num_devices`` (see
``repro_torch.gym.train.default_stages``).

The named ``CURRICULA`` map to the ROADMAP's scenario axes: the default
paper-like regime, extreme heterogeneity, flaky fleets, mixed job
complexity, and the all-of-the-above "full" curriculum. ``ScenarioSpec`` and
``CURRICULA`` are the reference's, field for field; the draws come from a
``torch.Generator`` with the reference's distributions.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """Per-episode scenario distribution.

    ``a_lo`` anchors the fastest device class; each episode draws a
    heterogeneity SPREAD in decades from ``hetero_decades`` and scatters
    device capabilities log-uniformly across it — so one batch contains
    both near-homogeneous and 100x-spread fleets. ``tau_range`` draws
    per-job local epochs (the job mix); ``failure_range`` draws the
    episode's device drop probability.
    """

    a_lo: float = 2e-4
    hetero_decades: Tuple[float, float] = (0.7, 1.3)
    mu_range: Tuple[float, float] = (1.0, 10.0)
    data_range: Tuple[float, float] = (200.0, 600.0)
    tau_range: Tuple[int, int] = (5, 5)
    failure_range: Tuple[float, float] = (0.0, 0.0)
    # Online-traffic axis (mirrors the repro_torch.serve service's dynamic
    # job sets): each job arrives at a step drawn from ``arrival_window``
    # and stays for a lifetime drawn from ``lifetime`` (both in global env
    # steps); (0, 0) means every job is live for the whole episode. Job 0
    # is always anchored live so an episode never goes fully idle. Inactive
    # jobs are plan-masked in rollouts — an empty plan is a zero-cost,
    # zero-gradient no-op round.
    arrival_window: Tuple[float, float] = (0.0, 0.0)
    lifetime: Tuple[float, float] = (0.0, 0.0)
    # Fault axes beyond uniform dropouts (mirroring repro_torch.faults.
    # FaultSpec): per-episode straggler rate (devices whose compute time is
    # multiplied by ``straggler_slowdown``) and correlated fault domains —
    # devices are scattered over ``num_domains`` groups and a whole group
    # drops together with per-round probability drawn from
    # ``domain_outage_range``.
    straggler_range: Tuple[float, float] = (0.0, 0.0)
    straggler_slowdown: float = 3.0
    num_domains: int = 0
    domain_outage_range: Tuple[float, float] = (0.0, 0.0)


CURRICULA: Dict[str, ScenarioSpec] = {
    # Paper-like regime: the DevicePool.heterogeneous defaults (10x spread).
    "default": ScenarioSpec(),
    # Edge fleets with up to ~300x capability spread.
    "hetero": ScenarioSpec(hetero_decades=(1.0, 2.5)),
    # Unreliable fleets: up to 30% of a cohort drops every round.
    "flaky": ScenarioSpec(failure_range=(0.0, 0.3)),
    # Mixed job complexity: per-job local epochs drawn from [1, 10].
    "mixed-jobs": ScenarioSpec(tau_range=(1, 10)),
    # Everything at once — the hardest training distribution.
    "full": ScenarioSpec(hetero_decades=(0.7, 2.5), tau_range=(1, 10),
                         failure_range=(0.0, 0.3)),
    # Online traffic: jobs arrive mid-episode and depart after a finite
    # lifetime (the repro_torch.serve regime) — policies must stay robust
    # to the fairness-count and occupancy shifts of a changing job mix.
    "arrivals": ScenarioSpec(arrival_window=(0.0, 24.0),
                             lifetime=(8.0, 48.0)),
    # Rich fault regime matching the engine's faults axis: uniform dropouts
    # PLUS stragglers and correlated fault-domain outages — policies must
    # learn that a slow or outage-prone cohort is a cost, not just a risk.
    "faults": ScenarioSpec(failure_range=(0.0, 0.2),
                           straggler_range=(0.0, 0.3),
                           num_domains=8,
                           domain_outage_range=(0.0, 0.05)),
}


class ScenarioDraw(NamedTuple):
    """E concrete scenarios (the output of ``sample_scenario``)."""

    a: torch.Tensor               # (E, K)
    mu: torch.Tensor              # (E, K)
    data: torch.Tensor            # (E, K, M)
    taus: torch.Tensor            # (E, M) f32
    failure_rate: torch.Tensor    # (E,)
    job_start: torch.Tensor       # (E, M)
    job_end: torch.Tensor         # (E, M)
    straggler_rate: torch.Tensor  # (E,)
    domain: torch.Tensor          # (E, K) int64 fault-domain assignment
    domain_rate: torch.Tensor     # (E,) per-round whole-domain outage prob


def _uniform(g: torch.Generator, shape, lo: float, hi: float,
             device) -> torch.Tensor:
    return lo + torch.rand(shape, generator=g, device=device) * (hi - lo)


def sample_scenario(generator: torch.Generator, scen: ScenarioSpec,
                    num_devices: int, num_jobs: int, num_envs: int,
                    device) -> ScenarioDraw:
    """Draw ``num_envs`` scenarios as a ``ScenarioDraw`` of f32 tensors on
    ``device`` (``generator`` lives there too)."""
    E, K, M = num_envs, num_devices, num_jobs
    g, dev = generator, device
    spread = _uniform(g, (E, 1), *scen.hetero_decades, dev)
    # Log-uniform capabilities over the episode's spread (in decades).
    a = scen.a_lo * 10.0 ** (torch.rand((E, K), generator=g, device=dev)
                             * spread)
    mu = _uniform(g, (E, K), *scen.mu_range, dev)
    data = _uniform(g, (E, K, M), *scen.data_range, dev)
    taus = torch.randint(scen.tau_range[0], scen.tau_range[1] + 1, (E, M),
                         generator=g, device=dev).to(torch.float32)
    failure_rate = _uniform(g, (E,), *scen.failure_range, dev)
    # Job activity windows. Job 0 anchors: always live from step 0 for the
    # whole episode.
    if scen.arrival_window == (0.0, 0.0):
        job_start = torch.zeros((E, M), device=dev)
    else:
        job_start = _uniform(g, (E, M), *scen.arrival_window, dev)
        job_start[:, 0] = 0.0
    if scen.lifetime == (0.0, 0.0):
        job_end = torch.full((E, M), torch.inf, device=dev)
    else:
        job_end = job_start + _uniform(g, (E, M), *scen.lifetime, dev)
        job_end[:, 0] = torch.inf
    straggler_rate = _uniform(g, (E,), *scen.straggler_range, dev)
    if scen.num_domains > 0:
        domain = torch.randint(0, scen.num_domains, (E, K), generator=g,
                               device=dev)
        domain_rate = _uniform(g, (E,), *scen.domain_outage_range, dev)
    else:
        domain = torch.zeros((E, K), dtype=torch.int64, device=dev)
        domain_rate = torch.zeros((E,), device=dev)
    return ScenarioDraw(a, mu, data, taus, failure_rate, job_start, job_end,
                        straggler_rate, domain, domain_rate)
