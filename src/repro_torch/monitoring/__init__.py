"""Monitoring: the port's observability layer.

- ``trace``   — zero-cost-when-disabled span tracer with Chrome/Perfetto
  trace-event JSON export (``span("schedule")``, device-timed
  ``device_span("local_sgd")``, counters, instants); instruments the
  engine, the fused FL runtime, the fused searchers, and the scheduler
  service.
- ``bus``     — synchronous pub/sub ``EventBus`` carrying engine
  ``round``/``round_begin``/``job_done`` and serve lifecycle events to
  sinks.
- ``metrics`` — ``MetricsLogger`` JSONL sink (batched flushing) +
  ``StepTimer``.
- ``audit``   — ``SchedulerAudit`` per-decision log (estimated vs realized
  cost, degraded rounds, scheduler name).
- ``session`` — ``ObsSpec`` (the spec's ``obs`` axis) + ``ObsSession``
  (declarative wiring: ``--set obs.trace_path=trace.json`` on any run).
- ``report``  — per-phase wall-clock breakdowns and run diffs
  (``python -m repro_torch.monitoring report``).
"""

from repro_torch.monitoring.audit import SchedulerAudit
from repro_torch.monitoring.bus import EventBus
from repro_torch.monitoring.metrics import MetricsLogger, StepTimer
from repro_torch.monitoring.session import ObsSession, ObsSpec
from repro_torch.monitoring.trace import Tracer, span

__all__ = ["MetricsLogger", "StepTimer", "SchedulerAudit", "EventBus",
           "ObsSession", "ObsSpec", "Tracer", "span"]
