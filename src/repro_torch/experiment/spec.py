"""``ExperimentSpec``: the one declarative front door to the MJ-FL system.

A spec is a frozen, JSON-round-trippable description of a complete multi-job
federated-learning experiment: the jobs, the device pool, the cost-model
coefficients, the scheduler (by registry name) and its search backend
(``search_backend``: only the host reference is ported), the runtime
(``synthetic`` closed-form convergence, or ``real_fl`` training on the CNN
zoo), the training execution knobs (``TrainSpec``: fused engine, cohort
buckets, eval cadence),
the fault/straggler/queueing knobs of the engine, and the ``policy`` axis
(a policy-zoo entry, ROADMAP module 9). ``spec.build(device=...)`` wires the
``DevicePool -> CostModel -> calibrate -> scheduler -> runtime ->
MultiJobEngine`` chain that every example/benchmark/test used to assemble by
hand; ``spec.run()`` executes it and returns an ``ExperimentResult`` whose
``to_dict()`` embeds the spec, so any saved result is a replayable spec.

All randomness is seeded from the spec (pool seed, scheduler seed, runtime
seed, engine seed), so equal specs reproduce results bit-for-bit, and the
numpy-driven paths reproduce the reference ``repro`` bit-for-bit. The
device the tensor work runs on (scoring backends and the ``real_fl``
runtime) is an argument of ``build``/``run`` (default ``"cuda"``), never a
spec field, so the reference's spec and result JSON load here unchanged;
``from_dict`` maps its scoring backends ``jax``/``pallas`` to
``torch``/``cuda``.

Axes the port does not run yet raise ``NotImplementedError`` naming their
ROADMAP module: a non-inert ``slo`` or an active ``obs`` (8), ``policy``
(9), ``fleet.num_shards`` > 1 (7) and the language-model arch ids (10).
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.config.base import ArchFamily, JobConfig, ModelConfig
from repro_torch.core.cost import CostModel
from repro_torch.core.devices import DevicePool
from repro_torch.core.multijob import MultiJobEngine, RoundRecord
from repro_torch.experiment.registry import RUNTIMES, SCHEDULERS
from repro_torch.experiment.slo import SLOSpec
from repro_torch.faults import FaultSpec
from repro_torch.monitoring.session import ObsSpec

STUB_MODEL = "stub"
# The reference's scoring backends -> the port's.
BACKEND_ALIASES = {"jax": "torch", "pallas": "cuda"}


def port_backend(name: Optional[str]) -> Optional[str]:
    """A scoring backend named by a reference spec, in the port's terms."""
    return BACKEND_ALIASES.get(name, name)


def _resolve_model(job: "JobSpec") -> ModelConfig:
    """Resolve a JobSpec's model id to a ModelConfig named after the job.

    ``stub`` is the scheduler-plane placeholder (a flatten-only classifier —
    never trained by the synthetic runtime, but it gives the engine a valid
    config and the summary a stable key). Any other id resolves through the
    arch registry (``paper-lenet5``, ``paper-vgg16``, ...); the
    language-model ids raise ``NotImplementedError`` (ROADMAP module 10).
    """
    if job.model == STUB_MODEL:
        return ModelConfig(name=job.name, family=ArchFamily.CNN,
                           cnn_spec=(("flatten",),), input_shape=(4, 4, 1),
                           num_classes=10)
    from repro_torch.config.registry import get_arch

    cfg = get_arch(job.model)
    return dataclasses.replace(cfg, name=job.name)


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """One FL job, declaratively: what to train, to which target, how fast
    it converges under the synthetic runtime."""

    name: str
    model: str = STUB_MODEL         # arch-registry id, or "stub"
    target_metric: float = 0.8
    max_rounds: int = 150
    local_epochs: int = 5
    batch_size: int = 32
    lr: float = 0.05
    # Synthetic-runtime convergence rate b0 (Formula 13); None -> runtime
    # default. Encodes job complexity ordering (LeNet > CNN > VGG).
    convergence_rate: Optional[float] = None

    def to_job_config(self, job_id: int) -> JobConfig:
        return JobConfig(job_id=job_id, model=_resolve_model(self),
                         target_metric=self.target_metric,
                         max_rounds=self.max_rounds,
                         local_epochs=self.local_epochs,
                         batch_size=self.batch_size, lr=self.lr)


@dataclasses.dataclass(frozen=True)
class PoolSpec:
    """The heterogeneous device pool (Formula 4 shifted-exponential model)."""

    num_devices: int = 100
    seed: int = 0
    a_range: Tuple[float, float] = (2e-4, 2e-3)
    mu_range: Tuple[float, float] = (1.0, 10.0)
    data_range: Tuple[int, int] = (200, 600)
    # Optional per-job multiplier on data sizes (cluster scheduling folds
    # per-arch step cost into slice-seconds this way). Length must equal the
    # number of jobs.
    job_weights: Optional[Tuple[float, ...]] = None

    def build(self, num_jobs: int) -> DevicePool:
        pool = DevicePool.heterogeneous(
            self.num_devices, num_jobs, seed=self.seed,
            a_range=tuple(self.a_range), mu_range=tuple(self.mu_range),
            data_range=tuple(self.data_range))
        if self.job_weights is not None:
            w = np.asarray(self.job_weights, dtype=np.float64)
            if w.shape != (num_jobs,):
                raise ValueError(
                    f"job_weights has shape {w.shape}, expected ({num_jobs},)")
            pool.data_sizes = pool.data_sizes * w[None, :]
        return pool


@dataclasses.dataclass(frozen=True)
class CostSpec:
    """Formula 2 coefficients; ``calibrate`` normalizes the two terms from
    the pool so alpha/beta are unitless (the repo-wide default)."""

    alpha: float = 4.0
    beta: float = 0.25
    delta_fairness: bool = True
    calibrate: bool = True

    def build(self, pool: DevicePool, taus: List[float], n_sel: int,
              scoring_backend: str = "auto",
              device: str = "cuda") -> CostModel:
        cm = CostModel(pool, alpha=self.alpha, beta=self.beta,
                       delta_fairness=self.delta_fairness,
                       scoring_backend=scoring_backend, device=device)
        if self.calibrate:
            cm.calibrate(taus, n_sel=n_sel)
        return cm


@dataclasses.dataclass(frozen=True)
class FleetSpec:
    """Fleet-scale axis: pool size, candidate count, and backends.

    ``num_devices``/``n_sel`` override the pool/engine sizing when set
    (so one preset sweeps K without re-deriving the rest of the spec);
    ``candidates`` overrides the candidate-set size of searching schedulers
    (BODS/DNN ``num_candidates``, genetic ``population``); ``scoring_backend``
    selects the plan-scoring path: ``numpy | torch | cuda | auto``;
    ``search_backend`` selects the plan-SEARCH path of the searching
    schedulers (SA/genetic): ``host`` (the sequential numpy reference) or
    ``fused`` (ROADMAP module 5, raises); ``num_shards`` None/1 = single
    lane, anything else is ROADMAP module 7 and raises.
    """

    num_devices: Optional[int] = None
    n_sel: Optional[int] = None
    candidates: Optional[int] = None
    scoring_backend: str = "auto"
    search_backend: str = "fused"
    num_shards: Optional[Any] = None  # None | int | "auto" | 0 (= auto)


@dataclasses.dataclass(frozen=True)
class TrainSpec:
    """Training-runtime execution knobs of the ``real_fl`` runtime: fused or
    unfused, cohort buckets, eval cadence, robust aggregation."""

    fused: bool = True
    buckets: Optional[Tuple[int, ...]] = None
    eval_every: int = 1
    robust: bool = False
    reject_mult: float = 4.0


@dataclasses.dataclass(frozen=True)
class ArrivalsSpec:
    """Online traffic axis of the scheduler service (ROADMAP module 8):
    dynamic job arrivals/departures and device churn. Carried so that specs
    round-trip; as in the reference, ``build``/``run`` run ``spec.jobs`` as
    a closed job set whatever this axis holds."""

    mode: str = "poisson"               # "poisson" | "trace"
    seed: int = 0
    horizon: float = 20000.0            # simulated seconds of traffic
    interarrival: float = 1500.0        # mean seconds between job arrivals
    # Mean tenant lifetime before voluntary departure; None -> tenants run
    # to completion (target/max_rounds) and only the engine retires them.
    mean_lifetime: Optional[float] = None
    # A departing tenant returns later with this probability — the warm
    # hand-off path (scheduler per-job state follows the tenant).
    readmit_prob: float = 0.0
    max_concurrent: int = 4             # admission-control budget (live jobs)
    # Device churn: mean seconds between churn events (None -> no churn),
    # the fleet fraction departing per event, how long until they rejoin,
    # and the multiplicative capability drift (on ``a``) applied on rejoin.
    churn_interarrival: Optional[float] = None
    churn_fraction: float = 0.02
    rejoin_after: float = 2000.0
    drift: float = 1.0
    trace_path: Optional[str] = None    # mode="trace" input


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """A complete multi-job FL experiment. ``build()`` -> ``Experiment``,
    ``run()`` -> ``ExperimentResult``; ``to_dict``/``from_dict`` round-trip
    through JSON."""

    jobs: Tuple[JobSpec, ...]
    pool: PoolSpec = PoolSpec()
    cost: CostSpec = CostSpec()
    fleet: FleetSpec = FleetSpec()
    # Convenience aliases for fleet.scoring_backend / fleet.search_backend
    # (they win when set), so ``ExperimentSpec(..., scoring_backend="cuda")``
    # and ``--set search_backend=host`` work without nesting.
    scoring_backend: Optional[str] = None
    search_backend: Optional[str] = None
    scheduler: str = "random"
    scheduler_seed: int = 0
    scheduler_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    runtime: str = "synthetic"
    runtime_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    train: TrainSpec = TrainSpec()
    # Observability axis (trace, metrics and audit sinks): ROADMAP module 8.
    obs: ObsSpec = ObsSpec()
    # Policy axis (a policy-zoo entry warm-starting the scheduler): ROADMAP
    # module 9.
    policy: Optional[str] = None
    policy_dir: str = "policies"
    # Online traffic axis (the scheduler service, ROADMAP module 8).
    arrivals: Optional[ArrivalsSpec] = None
    non_iid: bool = True            # data distribution (both runtime kinds)
    n_sel: Optional[int] = None     # devices per round; None -> 10% of pool
    # Fault model (``repro_torch.faults.FaultSpec``): crash/dropout/straggler/
    # domain/corruption rates, quarantine backoff, round deadline. None with
    # ``failure_rate > 0`` maps the deprecated alias below onto the axis
    # (``effective_faults``).
    faults: Optional[FaultSpec] = None
    # Serve-resilience axis (``repro_torch.experiment.slo.SLOSpec``): None
    # or an inert spec runs the plain engine; anything else is ROADMAP
    # module 8.
    slo: Optional[SLOSpec] = None
    # DEPRECATED alias (uniform transient dropouts, fixed cooldown) — kept
    # for old spec JSONs; subsumed by the ``faults`` axis, which wins when
    # both are set.
    failure_rate: float = 0.0
    failure_cooldown: float = 60.0
    # Engine knobs: straggler over-provisioning cut, queueing-aware release
    # horizon.
    over_provision: float = 1.0
    release_horizon: float = 0.0
    engine_seed: int = 12345
    name: str = "experiment"

    def __post_init__(self):
        object.__setattr__(self, "jobs", tuple(self.jobs))
        if not self.jobs:
            raise ValueError("ExperimentSpec needs at least one job")

    # ---- construction ----

    def effective_num_devices(self) -> int:
        return self.fleet.num_devices or self.pool.num_devices

    def effective_n_sel(self) -> int:
        n = self.fleet.n_sel or self.n_sel
        return n or max(1, int(round(0.1 * self.effective_num_devices())))

    def effective_scoring_backend(self) -> str:
        return self.scoring_backend or self.fleet.scoring_backend

    def effective_search_backend(self) -> str:
        return self.search_backend or self.fleet.search_backend

    def effective_faults(self) -> Optional[FaultSpec]:
        """The resolved fault model: the ``faults`` axis when set, else the
        deprecated ``failure_rate``/``failure_cooldown`` alias mapped onto
        it (fixed-cooldown uniform dropouts), else None."""
        if self.faults is not None:
            return self.faults
        if self.failure_rate > 0.0:
            return FaultSpec.from_legacy(self.failure_rate,
                                         self.failure_cooldown,
                                         seed=self.engine_seed)
        return None

    def effective_slo(self) -> Optional[SLOSpec]:
        """The resolved resilience axis: the ``slo`` spec when set and NOT
        inert (an inert spec must change nothing — the bit-identity
        contract), else None."""
        if self.slo is not None and not self.slo.inert:
            return self.slo
        return None

    def check_ported(self) -> None:
        """Raise ``NotImplementedError`` for an axis this port does not run
        yet (each names its ROADMAP module); nothing is quietly ignored."""
        if self.effective_slo() is not None:
            raise NotImplementedError(
                "a non-inert slo axis (serve resilience) is ROADMAP module "
                "8, not ported yet")
        if self.obs.active:
            raise NotImplementedError(
                "an active obs axis (ObsSession: trace, metrics, audit "
                "sinks) is ROADMAP module 8, not ported yet")
        if self.policy:
            raise NotImplementedError(
                "the policy axis (policy zoo, scheduler gym) is ROADMAP "
                "module 9, not ported yet")
        if self.fleet.num_shards not in (None, 1):
            raise NotImplementedError(
                f"fleet.num_shards={self.fleet.num_shards!r}: fleet sharding "
                "(core/shard.py) is ROADMAP module 7, not ported yet")

    def _scheduler_params(self):
        import inspect

        factory = SCHEDULERS.get(self.scheduler)
        fn = factory.__init__ if inspect.isclass(factory) else factory
        return inspect.signature(fn).parameters

    def _candidate_kwargs(self) -> Dict[str, Any]:
        """Map fleet.candidates / the search-backend axis onto the
        scheduler's own knobs, where it has them."""
        params = self._scheduler_params()
        out: Dict[str, Any] = {}
        if "search_backend" in params:
            out["search_backend"] = self.effective_search_backend()
        if self.fleet.candidates is not None:
            for knob in ("num_candidates", "population"):
                if knob in params:
                    out[knob] = int(self.fleet.candidates)
                    break
        return out

    def build(self, device: str = "cuda") -> "Experiment":
        """Wire pool -> cost model -> scheduler -> runtime -> engine. The
        torch/cuda scoring backends and the runtime's tensor work run on
        ``device``."""
        self.check_ported()
        jobs = [js.to_job_config(i) for i, js in enumerate(self.jobs)]
        pool_spec = self.pool
        if self.fleet.num_devices is not None:
            pool_spec = dataclasses.replace(
                pool_spec, num_devices=self.fleet.num_devices)
        pool = pool_spec.build(len(jobs))
        n_sel = self.effective_n_sel()
        cost_model = self.cost.build(
            pool, [float(j.local_epochs) for j in jobs], n_sel,
            scoring_backend=self.effective_scoring_backend(),
            device=str(device))
        # scheduler_kwargs may override the default seed/cost_model wiring
        sched_kwargs = {
            "cost_model": cost_model, "seed": self.scheduler_seed,
            **self._candidate_kwargs(),
            **dict(self.scheduler_kwargs)}
        scheduler = SCHEDULERS.create(self.scheduler, **sched_kwargs)
        runtime = RUNTIMES.get(self.runtime)(
            self, jobs, pool, device=str(device), **dict(self.runtime_kwargs))
        engine = MultiJobEngine(
            jobs, pool, cost_model, scheduler, runtime,
            n_sel=n_sel,
            faults=self.effective_faults(),
            over_provision=self.over_provision,
            release_horizon=self.release_horizon,
            rng=np.random.default_rng(self.engine_seed))
        return Experiment(spec=self, engine=engine)

    def run(self, verbose: bool = False,
            on_round: Optional[Callable[[RoundRecord], None]] = None,
            device: str = "cuda") -> "ExperimentResult":
        return self.build(device=device).run(verbose=verbose,
                                             on_round=on_round)

    # ---- serialization ----

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_dict(cls, d: dict) -> "ExperimentSpec":
        d = dict(d)
        d["jobs"] = tuple(JobSpec(**j) for j in d["jobs"])
        pool = dict(d.get("pool", {}))
        for key in ("a_range", "mu_range", "data_range", "job_weights"):
            if pool.get(key) is not None:
                pool[key] = tuple(pool[key])
        d["pool"] = PoolSpec(**pool)
        d["cost"] = CostSpec(**d.get("cost", {}))
        fleet = dict(d.get("fleet", {}))
        if "scoring_backend" in fleet:
            fleet["scoring_backend"] = port_backend(fleet["scoring_backend"])
        d["fleet"] = FleetSpec(**fleet)
        d["scoring_backend"] = port_backend(d.get("scoring_backend"))
        train = dict(d.get("train", {}))
        if train.get("buckets") is not None:
            train["buckets"] = tuple(train["buckets"])
        d["train"] = TrainSpec(**train)
        d["obs"] = ObsSpec(**d.get("obs", {}))
        if d.get("arrivals") is not None:
            d["arrivals"] = ArrivalsSpec(**d["arrivals"])
        if d.get("faults") is not None:
            d["faults"] = FaultSpec(**d["faults"])
        if d.get("slo") is not None:
            d["slo"] = SLOSpec(**d["slo"])
        return cls(**d)

    @classmethod
    def from_json(cls, s: str) -> "ExperimentSpec":
        return cls.from_dict(json.loads(s))

    @classmethod
    def load(cls, path: str) -> "ExperimentSpec":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")

    _NESTED_TUPLE_FIELDS = ("a_range", "mu_range", "data_range",
                            "job_weights", "buckets")

    def replace(self, **changes) -> "ExperimentSpec":
        """``dataclasses.replace`` that also accepts dicts for the nested
        axes (``pool``/``cost``/``fleet``/``train``), merged over the current
        values — so ``spec.replace(train={"eval_every": 2})`` and the CLI's
        ``--set train={...}`` work without rebuilding the whole sub-spec."""
        _optional = {"arrivals": ArrivalsSpec, "faults": FaultSpec,
                     "slo": SLOSpec}
        for key in ("pool", "cost", "fleet", "train", "obs", "arrivals",
                    "faults", "slo"):
            v = changes.get(key)
            if isinstance(v, dict):
                v = {k: (tuple(val) if k in self._NESTED_TUPLE_FIELDS
                         and val is not None else val)
                     for k, val in v.items()}
                cur = getattr(self, key)
                changes[key] = (dataclasses.replace(cur, **v)
                                if cur is not None else _optional[key](**v))
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class Experiment:
    """A built (but not yet run) experiment: the spec plus the live engine.

    The engine is exposed for instrumentation (``engine.counts``,
    ``engine.records``, monitoring hooks) — scenario wiring itself should
    stay in the spec."""

    spec: ExperimentSpec
    engine: MultiJobEngine

    def run(self, verbose: bool = False,
            on_round: Optional[Callable[[RoundRecord], None]] = None
            ) -> "ExperimentResult":
        t0 = time.time()
        self.engine.run(verbose=verbose, on_round=on_round)
        return ExperimentResult(
            spec=self.spec, summary=self.engine.summary(),
            records=list(self.engine.records), wall_s=time.time() - t0)


def _record_to_dict(r: RoundRecord) -> dict:
    d = dataclasses.asdict(r)
    d["device_ids"] = np.asarray(r.device_ids).astype(int).tolist()
    d["dropped"] = np.asarray(r.dropped).astype(int).tolist()
    d["corrupt_ids"] = np.asarray(r.corrupt_ids).astype(int).tolist()
    d["failed_ids"] = np.asarray(r.failed_ids).astype(int).tolist()
    d["degraded"] = bool(r.degraded)
    return d


def _record_from_dict(d: dict) -> RoundRecord:
    d = dict(d)
    d["device_ids"] = np.asarray(d["device_ids"], dtype=int)
    d["dropped"] = np.asarray(d["dropped"], dtype=int)
    d["corrupt_ids"] = np.asarray(d.get("corrupt_ids", []), dtype=int)
    d["failed_ids"] = np.asarray(d.get("failed_ids", []), dtype=int)
    d.setdefault("rung", None)
    d.setdefault("decision_ms", None)
    return RoundRecord(**d)


@dataclasses.dataclass
class ExperimentResult:
    """What a run produced: per-job summary (paper Tables 1/2/5 quantities),
    the full round trace, and the spec that generated it."""

    spec: ExperimentSpec
    summary: Dict[str, dict]
    records: List[RoundRecord]
    wall_s: float = 0.0

    def to_dict(self) -> dict:
        return dict(spec=self.spec.to_dict(), summary=self.summary,
                    records=[_record_to_dict(r) for r in self.records],
                    wall_s=self.wall_s)

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_dict(cls, d: dict) -> "ExperimentResult":
        return cls(spec=ExperimentSpec.from_dict(d["spec"]),
                   summary=d["summary"],
                   records=[_record_from_dict(r) for r in d["records"]],
                   wall_s=d.get("wall_s", 0.0))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")

    @classmethod
    def load(cls, path: str) -> "ExperimentResult":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    @property
    def makespan(self) -> float:
        return max(v["makespan"] for v in self.summary.values())
