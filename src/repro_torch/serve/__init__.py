"""Online multi-tenant scheduler service (``python -m repro_torch.serve``).

The classic experiment pipeline runs a CLOSED job set: every job exists at
t=0 and the engine drains the heap. Production multi-job FL is open-world —
tenants submit jobs while others are mid-flight, devices leave and rejoin
the fleet with drifted capabilities, and the scheduler must re-plan
incrementally instead of re-searching from scratch on every change.

- ``repro_torch.serve.traffic``  — arrival/departure/churn event streams
  (seeded Poisson generation, JSON trace replay).
- ``repro_torch.serve.service``  — the event loop: admission control under a
  concurrent-job budget, mid-run ``add_job``/``retire_job`` on the engine,
  incremental plan rescoring, scheduler warm hand-off across
  retire/readmit cycles.
- ``repro_torch.serve.metrics``  — decision-latency percentiles, throughput,
  queue depth, per-tenant cost/fairness accounting.
- ``repro_torch.serve.resilience`` — the SLO axis' runtime: the decision
  governor's degradation ladder (full -> incremental -> greedy ->
  last-good), per-tenant/per-fault-domain circuit breakers, and the
  stalled-round watchdog (``--set slo.decision_deadline_ms=...``).
- ``repro_torch.serve.persistence`` — crash-consistent service checkpoints
  (``repro_torch.checkpoint``) in the reference's layout, so either package
  resumes the other's.

The service's tensor work runs on ``device`` (``"cuda"`` unless the caller
asks for the CPU).
"""

from repro_torch.serve.metrics import LatencyStats, ServiceMetrics, ServiceReport
from repro_torch.serve.resilience import (RUNGS, BreakerBoard, CircuitBreaker,
                                    DecisionGovernor, RoundWatchdog,
                                    attach_resilience)
from repro_torch.serve.service import SchedulerService
from repro_torch.serve.traffic import (TrafficEvent, load_trace, poisson_trace,
                                 save_trace, trace_from_spec)

__all__ = [
    "RUNGS", "BreakerBoard", "CircuitBreaker", "DecisionGovernor",
    "LatencyStats", "RoundWatchdog", "SchedulerService", "ServiceMetrics",
    "ServiceReport", "TrafficEvent", "attach_resilience", "load_trace",
    "poisson_trace", "save_trace", "trace_from_spec",
]
