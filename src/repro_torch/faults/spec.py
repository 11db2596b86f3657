"""``FaultSpec``: the declarative fault model of one experiment.

One frozen, JSON-round-trippable axis describes everything that can go
wrong with a device mid-round:

- **Transient dropouts** (``dropout_rate``): the device fails this round,
  is excluded from aggregation, and is quarantined with EXPONENTIAL
  BACKOFF — ``cooldown * backoff**(strikes-1)`` seconds, capped at
  ``max_cooldown``; a successfully completed round resets the strike
  counter (readmission).
- **Crash faults** (``crash_rate``): the device is gone for good
  (``busy_until = inf`` — same semantics as fleet departure).
- **Straggler slowdowns** (``straggler_rate``/``straggler_slowdown``): a
  slowed device's realized compute time is multiplied — the tail the
  engine's over-provisioning cut and ``round_deadline`` both absorb.
- **Correlated fault domains** (``num_domains``/``domain_outage_rate``):
  devices are statically binned into racks/regions; a domain outage drops
  every scheduled device in the domain at once and parks them for
  ``domain_outage_duration`` seconds (no backoff escalation — the rack
  came back, the devices did nothing wrong).
- **Corrupted updates** (``corrupt_rate``/``corrupt_mode``): the device
  finishes on time but uploads garbage — all-NaN parameters
  (``"nan"``) or a delta blown up by ``corrupt_scale`` (``"scale"``).
  Robust runtimes (``TrainSpec.robust``) inject and reject these inside
  the fused round; otherwise the engine oracle-discards them before
  aggregation.
- **Deadline rounds** (``round_deadline``): FedCS-style partial
  aggregation — survivors slower than the deadline are cut and the round
  aggregates the on-time cohort only.

Every draw is keyed on ``(seed, purpose, job, round_idx)`` — NOT on a
shared stateful stream — so the schedule is replayable: any layer
(engine, runtime, a resumed service) independently recomputes the exact
same faults for a given round, in any order, any number of times.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

CORRUPT_MODES = ("nan", "scale")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Declarative fault model (see module docstring for semantics)."""

    seed: int = 0
    # Transient dropouts + escalating quarantine.
    dropout_rate: float = 0.0
    cooldown: float = 60.0
    backoff: float = 2.0
    max_cooldown: float = 3600.0
    # Permanent crashes.
    crash_rate: float = 0.0
    # Straggler slowdown multipliers.
    straggler_rate: float = 0.0
    straggler_slowdown: float = 3.0
    # Correlated fault domains (racks/regions). 0 domains = uncorrelated.
    num_domains: int = 0
    domain_outage_rate: float = 0.0
    domain_outage_duration: float = 500.0
    # Corrupted / NaN model updates.
    corrupt_rate: float = 0.0
    corrupt_mode: str = "nan"
    corrupt_scale: float = 100.0
    # FedCS-style per-round deadline (simulated seconds); None = no deadline.
    round_deadline: Optional[float] = None

    def __post_init__(self):
        if self.corrupt_mode not in CORRUPT_MODES:
            raise ValueError(f"corrupt_mode {self.corrupt_mode!r} not in "
                             f"{CORRUPT_MODES}")
        if self.backoff < 1.0:
            raise ValueError("backoff must be >= 1 (quarantines never shrink "
                             "with repeated failures)")
        for name in ("dropout_rate", "crash_rate", "straggler_rate",
                     "domain_outage_rate", "corrupt_rate"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be a probability, got {v}")

    @property
    def inert(self) -> bool:
        """True when this spec injects nothing (the engine skips the fault
        path entirely)."""
        return (self.dropout_rate == 0.0 and self.crash_rate == 0.0
                and self.straggler_rate == 0.0
                and (self.num_domains == 0 or self.domain_outage_rate == 0.0)
                and self.corrupt_rate == 0.0
                and self.round_deadline is None)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "FaultSpec":
        return cls(**d)

    @classmethod
    def from_legacy(cls, failure_rate: float, failure_cooldown: float = 60.0,
                    seed: int = 0) -> "FaultSpec":
        """Map the deprecated ``failure_rate``/``failure_cooldown`` engine
        kwargs onto the axis: uniform transient dropouts with a FIXED
        quarantine (``backoff=1``), matching the historical semantics."""
        return cls(seed=seed, dropout_rate=float(failure_rate),
                   cooldown=float(failure_cooldown), backoff=1.0,
                   max_cooldown=float(failure_cooldown))
