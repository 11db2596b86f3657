"""Traffic generation for the online scheduler service.

A trace is a time-sorted list of ``TrafficEvent``s — the EXTERNAL world the
service reacts to (what the engine's own event heap is to the internal
world). Three kinds:

- ``arrive``     — tenant submits a job built from catalogue template
                   ``template``; if the tenant departed earlier, this is a
                   READMISSION and the scheduler's per-job state follows it.
- ``depart``     — tenant voluntarily retires its job (mid-run churn, as
                   opposed to finishing by target/max_rounds).
- ``churn_out``  — ``devices`` leave the fleet.
- ``churn_in``   — those devices rejoin, capabilities drifted by ``drift``
                   (multiplier on the per-sample cost floor ``a``).

Traces are JSON-serializable (``save_trace``/``load_trace``) so a generated
stream can be replayed bit-identically across service configurations — the
incremental-vs-full rescoring comparison holds traffic fixed this way.
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.experiment.spec import ArrivalsSpec

EVENT_KINDS = ("arrive", "depart", "churn_out", "churn_in")


@dataclasses.dataclass
class TrafficEvent:
    t: float                              # simulated seconds
    kind: str                             # one of EVENT_KINDS
    tenant: Optional[str] = None          # arrive/depart
    template: Optional[int] = None        # arrive: index into spec.jobs
    devices: Optional[List[int]] = None   # churn_out/churn_in
    drift: float = 1.0                    # churn_in: multiplier on ``a``

    def __post_init__(self):
        if self.kind not in EVENT_KINDS:
            raise ValueError(f"unknown event kind {self.kind!r}")

    def to_dict(self) -> dict:
        d = {"t": self.t, "kind": self.kind}
        if self.tenant is not None:
            d["tenant"] = self.tenant
        if self.template is not None:
            d["template"] = self.template
        if self.devices is not None:
            d["devices"] = [int(k) for k in self.devices]
        if self.drift != 1.0:
            d["drift"] = self.drift
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "TrafficEvent":
        return cls(t=float(d["t"]), kind=d["kind"], tenant=d.get("tenant"),
                   template=d.get("template"), devices=d.get("devices"),
                   drift=float(d.get("drift", 1.0)))


def save_trace(events: Sequence[TrafficEvent], path: str) -> None:
    with open(path, "w") as f:
        json.dump([e.to_dict() for e in events], f, indent=2)
        f.write("\n")


def load_trace(path: str) -> List[TrafficEvent]:
    with open(path) as f:
        return [TrafficEvent.from_dict(d) for d in json.load(f)]


def poisson_trace(arrivals: ArrivalsSpec, num_templates: int,
                  num_devices: int) -> List[TrafficEvent]:
    """Seeded synthetic stream: Poisson job arrivals (exponential
    interarrivals), optional exponential tenant lifetimes with probabilistic
    readmission, and periodic device-churn out/in pairs. Deterministic in
    ``arrivals.seed`` — equal specs yield equal traces."""
    rng = np.random.default_rng(arrivals.seed)
    events: List[TrafficEvent] = []

    t, n = 0.0, 0
    while True:
        t += float(rng.exponential(arrivals.interarrival))
        if t >= arrivals.horizon:
            break
        tenant = f"tenant-{n:03d}"
        n += 1
        template = int(rng.integers(num_templates))
        events.append(TrafficEvent(t=t, kind="arrive", tenant=tenant,
                                   template=template))
        if arrivals.mean_lifetime is not None:
            t_dep = t + float(rng.exponential(arrivals.mean_lifetime))
            if t_dep < arrivals.horizon:
                events.append(TrafficEvent(t=t_dep, kind="depart",
                                           tenant=tenant))
                if rng.random() < arrivals.readmit_prob:
                    t_re = t_dep + float(
                        rng.exponential(arrivals.interarrival))
                    if t_re < arrivals.horizon:
                        # Same tenant, same template: the service hands the
                        # scheduler's per-job state across the gap.
                        events.append(TrafficEvent(
                            t=t_re, kind="arrive", tenant=tenant,
                            template=template))

    if arrivals.churn_interarrival is not None:
        n_out = max(1, int(round(arrivals.churn_fraction * num_devices)))
        t = 0.0
        while True:
            t += float(rng.exponential(arrivals.churn_interarrival))
            if t >= arrivals.horizon:
                break
            devs = rng.choice(num_devices, size=n_out, replace=False)
            devs = [int(k) for k in devs]
            events.append(TrafficEvent(t=t, kind="churn_out", devices=devs))
            events.append(TrafficEvent(t=t + arrivals.rejoin_after,
                                       kind="churn_in", devices=devs,
                                       drift=arrivals.drift))

    events.sort(key=lambda e: (e.t, EVENT_KINDS.index(e.kind)))
    return events


def trace_from_spec(arrivals: ArrivalsSpec, num_templates: int,
                    num_devices: int) -> List[TrafficEvent]:
    """Dispatch on ``arrivals.mode``: generate (poisson) or replay (trace)."""
    if arrivals.mode == "poisson":
        return poisson_trace(arrivals, num_templates, num_devices)
    if arrivals.mode == "trace":
        if not arrivals.trace_path:
            raise ValueError('arrivals.mode="trace" needs trace_path')
        return load_trace(arrivals.trace_path)
    raise ValueError(f"unknown arrivals mode {arrivals.mode!r}")
