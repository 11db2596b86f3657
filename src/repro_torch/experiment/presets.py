"""Named experiment presets: the scenarios the repo ships ready-to-run.

Each preset is a factory returning an ``ExperimentSpec`` — list them with
``list_presets()``, build one with ``get_preset(name, **factory_kwargs)``,
or from the shell::

    python -m repro_torch.experiment.cli preset paper-group-a --run
    python -m repro_torch.experiment.cli preset quickstart --out spec.json

Presets cover the paper's benchmark groups (Tables 1-2), the real-training
two-job testbed, and the beyond-paper fault-injection regime. The group
tables are copied from the reference's presets, so the same preset
arguments give the same spec on both sides.
"""

from __future__ import annotations

from typing import Dict, List

from repro_torch.experiment.registry import Registry
from repro_torch.experiment.slo import SLOSpec
from repro_torch.experiment.spec import (ArrivalsSpec, ExperimentSpec, FleetSpec,
                                   JobSpec, PoolSpec)
from repro_torch.faults import FaultSpec

PRESETS = Registry("preset")
register_preset = PRESETS.register


def get_preset(name: str, **kwargs) -> ExperimentSpec:
    return PRESETS.create(name, **kwargs)


def list_presets() -> List[str]:
    return PRESETS.names()


# Paper groups in scheduler-benchmark form: per-job complexity is encoded as
# (target_noniid, target_iid, convergence rate b0). Complexity ordering
# follows the paper: LeNet < CNN < VGG; AlexNet < CNN-B < ResNet. Non-IID
# targets sit ABOVE greedy's starvation ceiling (~0.73-0.76) and safely below
# the fair schedulers' ceiling so the paper's accuracy separation is the
# thing being measured, not seed luck at the asymptote.
PAPER_GROUPS: Dict[str, List[tuple]] = {
    "A": [("vgg16", 0.54, 0.54, 0.06), ("cnn-a", 0.78, 0.79, 0.12),
          ("lenet5", 0.79, 0.84, 0.20)],
    "B": [("resnet18", 0.58, 0.59, 0.08), ("cnn-b", 0.72, 0.72, 0.12),
          ("alexnet", 0.78, 0.84, 0.18)],
}


def paper_group(group: str, scheduler: str = "bods", non_iid: bool = True,
                seed: int = 1, num_devices: int = 100, n_sel: int = 10,
                max_rounds: int = 150) -> ExperimentSpec:
    """Paper Tables 1-2 scheduler-plane benchmark (synthetic convergence)."""
    jobs = tuple(
        JobSpec(name=name, target_metric=t_noniid if non_iid else t_iid,
                max_rounds=max_rounds, local_epochs=5, convergence_rate=rate)
        for name, t_noniid, t_iid, rate in PAPER_GROUPS[group])
    return ExperimentSpec(
        name=f"paper-group-{group.lower()}-{scheduler}",
        jobs=jobs, pool=PoolSpec(num_devices=num_devices, seed=seed),
        scheduler=scheduler, runtime="synthetic",
        runtime_kwargs={"seed": 2}, non_iid=non_iid, n_sel=n_sel)


@register_preset("paper-group-a")
def paper_group_a(**kwargs) -> ExperimentSpec:
    return paper_group("A", **kwargs)


@register_preset("paper-group-b")
def paper_group_b(**kwargs) -> ExperimentSpec:
    return paper_group("B", **kwargs)


@register_preset("quickstart")
def quickstart(scheduler: str = "bods", n_jobs: int = 3, target: float = 0.8,
               num_devices: int = 100, max_rounds: int = 150,
               seed: int = 1) -> ExperimentSpec:
    """3 identical synthetic jobs over 100 heterogeneous devices — the
    paper's core loop in under a minute."""
    return ExperimentSpec(
        name=f"quickstart-{scheduler}",
        jobs=tuple(JobSpec(name="clf", target_metric=target,
                           max_rounds=max_rounds) for _ in range(n_jobs)),
        pool=PoolSpec(num_devices=num_devices, seed=seed),
        scheduler=scheduler, runtime="synthetic",
        runtime_kwargs={"seed": 2}, n_sel=max(1, num_devices // 10))


@register_preset("real-fl-two-job")
def real_fl_two_job(scheduler: str = "bods", rounds: int = 15,
                    num_devices: int = 40, seed: int = 5,
                    lenet_target: float = 0.90,
                    cnn_target: float = 0.80) -> ExperimentSpec:
    """The paper's testbed in miniature: LeNet-5 + CNN-B, REAL vmap'd local
    SGD + FedAvg on non-IID synthetic shards, times simulated."""
    jobs = (
        JobSpec(name="paper-lenet5", model="paper-lenet5",
                target_metric=lenet_target, max_rounds=rounds,
                local_epochs=3, batch_size=32, lr=0.02),
        JobSpec(name="paper-cnn-b", model="paper-cnn-b",
                target_metric=cnn_target, max_rounds=rounds,
                local_epochs=3, batch_size=32, lr=0.02),
    )
    return ExperimentSpec(
        name=f"real-fl-two-job-{scheduler}",
        jobs=jobs, pool=PoolSpec(num_devices=num_devices, seed=seed),
        scheduler=scheduler, runtime="real_fl", non_iid=True, n_sel=5)


@register_preset("fleet-scale")
def fleet_scale(scheduler: str = "bods", num_devices: int = 10_000,
                n_sel: int = None, candidates: int = 512,
                scoring_backend: str = "torch",
                search_backend: str = "fused", n_jobs: int = 2,
                max_rounds: int = 5, seed: int = 1) -> ExperimentSpec:
    """Beyond-paper scale regime: a cross-device fleet of 10k-100k devices
    (cf. Liu et al., arXiv:2211.13430) scheduled through the batched
    device scoring core. The ``fleet`` axis carries pool size,
    candidate count, and scoring backend; everything else stays the
    quickstart scheduler-plane setup."""
    n_sel = n_sel or max(1, num_devices // 100)
    return ExperimentSpec(
        name=f"fleet-scale-{scheduler}-K{num_devices}",
        jobs=tuple(JobSpec(name="clf", target_metric=0.95,
                           max_rounds=max_rounds) for _ in range(n_jobs)),
        pool=PoolSpec(seed=seed),
        fleet=FleetSpec(num_devices=num_devices, n_sel=n_sel,
                        candidates=candidates,
                        scoring_backend=scoring_backend,
                        search_backend=search_backend),
        scheduler=scheduler, runtime="synthetic",
        runtime_kwargs={"seed": 2})


@register_preset("rlds-warmstart")
def rlds_warmstart(policy: str = "rlds-default",
                   policy_dir: str = "policies", n_jobs: int = 3,
                   num_devices: int = 100, max_rounds: int = 150,
                   seed: int = 1) -> ExperimentSpec:
    """Quickstart scenario driven by a gym-trained RLDS policy loaded from
    the policy zoo (train one first: ``python -m repro_torch.gym train
    --name rlds-default``). Construction skips the legacy 300-round
    constructor pre-training entirely — the warm start replaces it."""
    spec = quickstart(scheduler="rlds", n_jobs=n_jobs,
                      num_devices=num_devices, max_rounds=max_rounds,
                      seed=seed)
    return spec.replace(name=f"rlds-warmstart-{policy}", policy=policy,
                        policy_dir=policy_dir)


@register_preset("online-smoke")
def online_smoke(scheduler: str = "bods", num_devices: int = 60,
                 horizon: float = 20_000.0, interarrival: float = 900.0,
                 max_concurrent: int = 3, seed: int = 1) -> ExperimentSpec:
    """Online multi-tenant scheduler service in the small: a 2-template
    tenant catalogue served under Poisson arrivals with tenant departures,
    probabilistic readmission (the warm hand-off path), and device churn
    with capability drift — ``python -m repro_torch.serve --preset
    online-smoke``.
    Jobs are short (max_rounds) so arrivals genuinely interleave with
    completions inside the horizon."""
    jobs = (
        JobSpec(name="small", target_metric=0.95, max_rounds=12,
                local_epochs=3, convergence_rate=0.20),
        JobSpec(name="large", target_metric=0.95, max_rounds=20,
                local_epochs=5, convergence_rate=0.10),
    )
    return ExperimentSpec(
        name=f"online-smoke-{scheduler}",
        jobs=jobs, pool=PoolSpec(num_devices=num_devices, seed=seed),
        scheduler=scheduler, runtime="synthetic",
        runtime_kwargs={"seed": 2}, n_sel=max(1, num_devices // 10),
        arrivals=ArrivalsSpec(
            seed=seed, horizon=horizon, interarrival=interarrival,
            mean_lifetime=2_500.0, readmit_prob=0.5,
            max_concurrent=max_concurrent,
            churn_interarrival=4_000.0, churn_fraction=0.05,
            rejoin_after=2_000.0, drift=1.3))


@register_preset("slo-overload")
def slo_overload(scheduler: str = "bods", num_devices: int = 40,
                 horizon: float = 12_000.0, interarrival: float = 350.0,
                 max_concurrent: int = 2, max_queue_depth: int = 3,
                 breaker_threshold: int = 2,
                 watchdog_rounds: int = 5, seed: int = 3) -> ExperimentSpec:
    """Overload + chaos regime for the SLO axis: the online-smoke tenant
    catalogue arriving ~3x faster than the service can drain it, over a
    faulty fleet (dropouts, crashes, a domain outage schedule, corrupted
    uploads), with the full resilience stack armed — queue-depth
    degradation ladder, admission shedding, per-tenant/per-domain circuit
    breakers, bounded launch/aggregation retries, and the stalled-round
    watchdog. Deliberately leaves ``slo.decision_deadline_ms`` unset so the
    trajectory (including fired rungs) is bit-identical across crash/resume
    — the overload-chaos CI arm depends on that."""
    spec = online_smoke(scheduler=scheduler, num_devices=num_devices,
                        horizon=horizon, interarrival=interarrival,
                        max_concurrent=max_concurrent, seed=seed)
    return spec.replace(
        name=f"slo-overload-{scheduler}",
        faults=FaultSpec(
            seed=seed, dropout_rate=0.12, crash_rate=0.002,
            straggler_rate=0.10, straggler_slowdown=3.0,
            num_domains=4, domain_outage_rate=0.03, corrupt_rate=0.05),
        slo=SLOSpec(
            max_queue_depth=max_queue_depth, shed_policy="defer",
            breaker_threshold=breaker_threshold, breaker_cooldown=2_000.0,
            watchdog_rounds=watchdog_rounds,
            max_launch_retries=3, max_agg_retries=1))


@register_preset("fault-injection")
def fault_injection(scheduler: str = "bods", dropout_rate: float = 0.15,
                    crash_rate: float = 0.003,
                    straggler_rate: float = 0.10,
                    straggler_slowdown: float = 3.0,
                    num_domains: int = 8,
                    domain_outage_rate: float = 0.02,
                    corrupt_rate: float = 0.05,
                    round_deadline: float = None,
                    over_provision: float = 1.2,
                    num_devices: int = 100, seed: int = 1) -> ExperimentSpec:
    """Beyond-paper robustness regime, now the full ``faults`` axis
    (``repro_torch.faults.FaultSpec``): transient dropouts with escalating
    quarantine, rare permanent crashes, straggler slowdowns, correlated
    fault-domain outages, and corrupted (NaN) uploads — all from a seeded
    replayable schedule. Over-provisioning absorbs the straggler/failure
    tail; an optional FedCS-style ``round_deadline`` adds partial
    aggregation. The legacy ``failure_rate`` spec field remains a
    deprecated alias for plain uniform dropouts."""
    spec = quickstart(scheduler=scheduler, num_devices=num_devices, seed=seed)
    return spec.replace(
        name=f"fault-injection-{scheduler}",
        over_provision=over_provision,
        faults=FaultSpec(
            seed=seed, dropout_rate=dropout_rate, crash_rate=crash_rate,
            straggler_rate=straggler_rate,
            straggler_slowdown=straggler_slowdown,
            num_domains=num_domains, domain_outage_rate=domain_outage_rate,
            corrupt_rate=corrupt_rate, round_deadline=round_deadline))
