"""Service-side observability: decision latency, throughput, queue depth,
per-tenant accounting.

Decision latency here is WALL-CLOCK time of the scheduler-facing work the
service performs per traffic event (admission rescoring, plan search) — the
quantity an online deployment must bound — while everything else in the
simulator runs on simulated seconds. ``LatencyStats`` keeps raw samples (the
streams are short: one per traffic event) and reports p50/p99.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class LatencyStats:
    """Raw wall-clock samples (seconds) with percentile summaries."""

    samples: List[float] = dataclasses.field(default_factory=list)

    def add(self, seconds: float) -> None:
        self.samples.append(float(seconds))

    @property
    def count(self) -> int:
        return len(self.samples)

    def percentile(self, q: float) -> float:
        if not self.samples:
            return 0.0
        return float(np.percentile(np.asarray(self.samples), q))

    @property
    def p50(self) -> float:
        return self.percentile(50.0)

    @property
    def p99(self) -> float:
        return self.percentile(99.0)

    @property
    def mean(self) -> float:
        return float(np.mean(self.samples)) if self.samples else 0.0

    @property
    def total(self) -> float:
        return float(np.sum(self.samples)) if self.samples else 0.0

    def to_dict(self) -> dict:
        return {"count": self.count, "p50_s": self.p50, "p99_s": self.p99,
                "mean_s": self.mean, "total_s": self.total}


def jain_fairness(values: np.ndarray) -> float:
    """Jain's index over per-tenant service shares: 1 = perfectly even,
    1/n = one tenant got everything. Empty/zero input -> 1.0."""
    v = np.asarray(values, dtype=np.float64)
    if v.size == 0:
        return 1.0
    s = float(v.sum())
    if s <= 0.0:
        return 1.0
    return float(s * s / (v.size * float((v * v).sum())))


@dataclasses.dataclass
class TenantStats:
    """Per-tenant service accounting (accumulated over all of the tenant's
    jobs, including across a retire/readmit cycle)."""

    tenant: str
    template: int
    rounds: int = 0
    total_cost: float = 0.0
    total_round_time: float = 0.0
    last_fairness: float = 0.0
    best_accuracy: float = 0.0
    admissions: int = 0
    queued_at: Optional[float] = None   # transient: waiting for a slot

    def to_dict(self) -> dict:
        return {"tenant": self.tenant, "template": self.template,
                "rounds": self.rounds, "total_cost": self.total_cost,
                "total_round_time": self.total_round_time,
                "mean_cost": (self.total_cost / self.rounds
                              if self.rounds else 0.0),
                "best_accuracy": self.best_accuracy,
                "admissions": self.admissions}


@dataclasses.dataclass
class ServiceMetrics:
    """Mutable accumulator the service writes into as it runs."""

    decision_latency: LatencyStats = dataclasses.field(
        default_factory=LatencyStats)
    tenants: Dict[str, TenantStats] = dataclasses.field(default_factory=dict)
    queue_depth_samples: List[int] = dataclasses.field(default_factory=list)
    events_processed: int = 0
    arrivals: int = 0
    departures: int = 0
    readmissions: int = 0
    rejections: int = 0        # queued because the budget was full
    churn_events: int = 0
    rounds_completed: int = 0
    decisions: int = 0         # admission rescoring passes
    # SLO resilience accounting (the ``slo`` axis; all 0 without it).
    shed_arrivals: int = 0     # dropped: breaker open / queue full / latency
    deferrals: int = 0         # queued despite a free slot (p99 pressure)
    recoveries: int = 0        # watchdog checkpoint restores
    breaker_trips: int = 0     # breaker open transitions observed
    degraded_rounds: int = 0   # rounds whose plan came from a non-full rung

    def tenant(self, name: str, template: int) -> TenantStats:
        ts = self.tenants.get(name)
        if ts is None:
            ts = self.tenants[name] = TenantStats(tenant=name,
                                                  template=template)
        return ts

    def sample_queue_depth(self, depth: int) -> None:
        self.queue_depth_samples.append(int(depth))

    # ---- persistence (crash-consistent service resume) ----

    _COUNTERS = ("events_processed", "arrivals", "departures", "readmissions",
                 "rejections", "churn_events", "rounds_completed", "decisions",
                 "shed_arrivals", "deferrals", "recoveries", "breaker_trips",
                 "degraded_rounds")

    def to_state(self) -> dict:
        """Full mutable state as a JSON-serializable dict (raw latency and
        queue-depth samples included, so a resumed run's report percentiles
        match an uninterrupted one's — modulo wall-clock latency noise)."""
        return {
            **{k: getattr(self, k) for k in self._COUNTERS},
            "latency_samples": list(self.decision_latency.samples),
            "queue_depth_samples": list(self.queue_depth_samples),
            "tenants": [dataclasses.asdict(t) for t in self.tenants.values()],
        }

    def load_state(self, state: dict) -> None:
        # .get: checkpoints written before the SLO axis lack its counters.
        for k in self._COUNTERS:
            setattr(self, k, int(state.get(k, 0)))
        self.decision_latency = LatencyStats(
            samples=[float(s) for s in state["latency_samples"]])
        self.queue_depth_samples = [int(s)
                                    for s in state["queue_depth_samples"]]
        self.tenants = {d["tenant"]: TenantStats(**d)
                        for d in state["tenants"]}

    def report(self, sim_horizon: float, wall_s: float,
               resilience: Optional[dict] = None) -> "ServiceReport":
        rounds = np.asarray(
            [t.rounds for t in self.tenants.values()], dtype=np.float64)
        return ServiceReport(
            resilience=resilience,
            decision_latency=self.decision_latency.to_dict(),
            decisions_per_sec=(self.decisions / wall_s if wall_s > 0 else 0.0),
            rounds_per_sec=(self.rounds_completed / wall_s
                            if wall_s > 0 else 0.0),
            queue_depth_max=(max(self.queue_depth_samples)
                             if self.queue_depth_samples else 0),
            queue_depth_mean=(float(np.mean(self.queue_depth_samples))
                              if self.queue_depth_samples else 0.0),
            tenant_fairness=jain_fairness(rounds),
            tenants={k: t.to_dict() for k, t in self.tenants.items()},
            events_processed=self.events_processed,
            arrivals=self.arrivals, departures=self.departures,
            readmissions=self.readmissions, rejections=self.rejections,
            churn_events=self.churn_events,
            rounds_completed=self.rounds_completed,
            sim_horizon=sim_horizon, wall_s=wall_s)


@dataclasses.dataclass
class ServiceReport:
    """Immutable end-of-run summary (JSON-serializable)."""

    decision_latency: dict
    decisions_per_sec: float
    rounds_per_sec: float
    queue_depth_max: int
    queue_depth_mean: float
    tenant_fairness: float          # Jain index over per-tenant round counts
    tenants: Dict[str, dict]
    events_processed: int
    arrivals: int
    departures: int
    readmissions: int
    rejections: int
    churn_events: int
    rounds_completed: int
    sim_horizon: float
    wall_s: float
    # SLO resilience summary (``DecisionGovernor.summary`` + the service's
    # shed/defer/recovery counters); None when the axis is off.
    resilience: Optional[dict] = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")
