"""``SLOSpec``: the serve-plane service-level-objective axis.

One frozen, JSON-round-trippable axis describes how the online scheduler
service must DEGRADE under pressure instead of stalling (the graceful-
degradation contract of the serve plane, ``repro_torch.serve``):

- **Decision deadline** (``decision_deadline_ms``): a wall-clock latency
  budget on every scheduling decision. The decision governor picks the
  highest-quality rung of the degradation ladder — full search ->
  incremental rescore of the cached plan -> greedy fallback ->
  last-known-good plan — whose recent latency fits the budget, and records
  which rung fired in the round record.
- **Overload control** (``max_queue_depth``): deterministic queue-depth
  backpressure. Arrivals beyond the depth bound are SHED; a deep (but not
  full) queue degrades the decision ladder one rung at a time, and a
  rolling-p99 breach of the deadline defers (or sheds, ``shed_policy``)
  admissions even when a slot is free.
- **Circuit breakers** (``breaker_threshold``): per-tenant and
  per-fault-domain breakers open after N consecutive fault-quarantined
  ("bad") rounds, stay open for ``breaker_cooldown`` simulated seconds,
  then half-open for a single probe. Open tenant breakers shed that
  tenant's arrivals; open domain breakers mask the domain's devices out
  of scheduling. Breaker state is checkpointed (kill -9 safe).
- **Bounded retries** (``max_launch_retries``/``max_agg_retries``): the
  engine's transient-shortage relaunch path retries at most N times with
  exponential simulated-time backoff (``retry_base_delay * retry_backoff
  ** tries``) before launching a clamped cohort; aggregation failures are
  retried at most ``max_agg_retries`` times before the round is recorded
  degraded with carried-forward metrics. ``None``/0 keeps the historical
  retry-forever / fail-fast semantics bit-identically.
- **Watchdog** (``watchdog_rounds``): the service checks the engine's
  liveness invariant at every traffic-event boundary; a job stalled for N
  consecutive checks triggers an in-place restore from the newest
  committed checkpoint snapshot (at most ``max_recoveries``
  times per run).

Determinism contract: an INERT spec (the default — every knob off) must
leave executed trajectories bit-identical to ``slo=None``; with only the
deterministic knobs set (no ``decision_deadline_ms``), rung choices depend
only on simulated state, so crash/resume stays bit-identical too.
Wall-clock-driven degradation (the deadline) is intrinsically
non-replayable, which is why ``decision_ms`` rides in round records only
when the deadline is set.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

SHED_POLICIES = ("defer", "shed")


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """Declarative serve-resilience objectives (see module docstring)."""

    # Wall-clock latency budget per scheduling decision; None -> no budget.
    decision_deadline_ms: Optional[float] = None
    # A rung is eligible while its recent latency fits within
    # deadline * deadline_safety (headroom against noise spikes).
    deadline_safety: float = 0.8
    # Rolling window: per-rung latency samples and the admission p99.
    latency_window: int = 32
    # Every N latency-forced degradations, re-probe the next-better rung.
    rung_probe_every: int = 16
    # Admission backpressure: queue depth bound (None -> unbounded) and the
    # response to a rolling-p99 deadline breach ("defer" queues the arrival
    # even when a slot is free; "shed" drops it).
    max_queue_depth: Optional[int] = None
    shed_policy: str = "defer"
    # Event-bus watchdog: consecutive stalled liveness checks before a
    # checkpoint restore fires; 0 -> watchdog off.
    watchdog_rounds: int = 0
    max_recoveries: int = 3
    # Circuit breakers: N consecutive bad rounds opens (0 -> breakers off);
    # cooldown is SIMULATED seconds open before the half-open probe; a round
    # is "bad" for a tenant when it degraded or >= breaker_failure_frac of
    # its cohort was fault-quarantined.
    breaker_threshold: int = 0
    breaker_cooldown: float = 2000.0
    breaker_failure_frac: float = 0.5
    # Bounded launch retries (transient device shortage): None keeps the
    # legacy wait-for-next-release forever; N bounds it with exponential
    # simulated-time backoff, then launches whatever is available.
    max_launch_retries: Optional[int] = None
    retry_backoff: float = 2.0
    retry_base_delay: float = 1.0
    # Bounded aggregation/dispatch retries (runtime.run_round raising):
    # 0 keeps fail-fast; N retries then records a degraded round.
    max_agg_retries: int = 0

    def __post_init__(self):
        if self.shed_policy not in SHED_POLICIES:
            raise ValueError(f"shed_policy {self.shed_policy!r} not in "
                             f"{SHED_POLICIES}")
        if self.decision_deadline_ms is not None \
                and self.decision_deadline_ms <= 0:
            raise ValueError("decision_deadline_ms must be positive")
        if not 0.0 < self.deadline_safety <= 1.0:
            raise ValueError("deadline_safety must be in (0, 1]")
        if self.latency_window < 1:
            raise ValueError("latency_window must be >= 1")
        if self.rung_probe_every < 1:
            raise ValueError("rung_probe_every must be >= 1")
        if self.retry_backoff < 1.0:
            raise ValueError("retry_backoff must be >= 1 (retry delays "
                             "never shrink)")
        if not 0.0 < self.breaker_failure_frac <= 1.0:
            raise ValueError("breaker_failure_frac must be in (0, 1]")
        for name in ("watchdog_rounds", "max_recoveries", "breaker_threshold",
                     "max_agg_retries"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be >= 0")

    @property
    def inert(self) -> bool:
        """True when this spec changes nothing (the engine/service skip the
        resilience path entirely — the bit-identity contract)."""
        return (self.decision_deadline_ms is None
                and self.max_queue_depth is None
                and self.watchdog_rounds == 0
                and self.breaker_threshold == 0
                and self.max_launch_retries is None
                and self.max_agg_retries == 0)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "SLOSpec":
        return cls(**d)
