"""The ``obs`` experiment axis: declarative observability wiring.

``ObsSpec`` is a frozen JSON-round-trippable sub-spec on ``ExperimentSpec``
(``--set obs.trace_path=trace.json``, ``obs.metrics_path``,
``obs.audit_path``, ``obs.enabled``) so ANY preset / CLI / bench run can
emit a Perfetto trace, a metrics JSONL, and a scheduler audit log without
code changes. Setting any output path implies ``enabled``.

``ObsSession`` is the live wiring ``ExperimentSpec.build()`` creates from
an active ``ObsSpec``: it turns on the global span tracer
(``repro_torch.monitoring.trace``), builds an ``EventBus``, subscribes the
``MetricsLogger`` / ``SchedulerAudit`` sinks to the engine's ``round``
topic, and hangs itself plus the bus on the engine (``engine.obs``,
``engine.events``). ``close()`` writes the trace and closes every sink —
``Experiment.run`` and ``SchedulerService.run`` call it when the run ends.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.monitoring.audit import SchedulerAudit
from repro_torch.monitoring.bus import EventBus
from repro_torch.monitoring.metrics import MetricsLogger
from repro_torch.monitoring import trace


@dataclasses.dataclass(frozen=True)
class ObsSpec:
    """Observability axis: where (and whether) a run reports.

    ``enabled`` force-enables the span tracer even with no ``trace_path``
    (the trace then stays in memory — ``repro_torch.monitoring.trace.get_tracer``
    — for programmatic use); any non-None path implies enabled. ``trace_path``
    gets Chrome/Perfetto trace-event JSON (load it at
    https://ui.perfetto.dev); ``metrics_path`` gets one JSONL row per
    finished round (batched by ``flush_every``); ``audit_path`` gets the
    per-decision scheduler audit log.
    """

    enabled: bool = False
    trace_path: Optional[str] = None
    metrics_path: Optional[str] = None
    audit_path: Optional[str] = None
    flush_every: int = 1

    @property
    def active(self) -> bool:
        return bool(self.enabled or self.trace_path or self.metrics_path
                    or self.audit_path)


class ObsSession:
    """Live sinks + bus + tracer ownership for one observed run."""

    def __init__(self, spec: ObsSpec, scheduler: Optional[str] = None,
                 process_name: str = "repro"):
        self.spec = spec
        self.process_name = process_name
        self.bus = EventBus()
        self.metrics: Optional[MetricsLogger] = None
        self.audit: Optional[SchedulerAudit] = None
        self._closed = False
        if spec.metrics_path:
            self.metrics = MetricsLogger(spec.metrics_path,
                                         flush_every=spec.flush_every)
            self.bus.subscribe("round", self.metrics.on_round)
        if spec.audit_path:
            self.audit = SchedulerAudit(spec.audit_path, scheduler=scheduler)
            self.bus.subscribe("round", self.audit.on_round)
        # The tracer is module-global (the hot paths must not thread a
        # handle through every layer); the session owns enable/clear/save.
        self._trace = bool(spec.enabled or spec.trace_path)
        if self._trace:
            trace.get_tracer().clear()
            trace.enable()

    def attach(self, engine) -> "ObsSession":
        """Point the engine's publish hooks at this session's bus."""
        engine.events = self.bus
        engine.obs = self
        return self

    def close(self) -> None:
        """Write the trace (if a path was configured), release the global
        tracer, and close every sink. Idempotent."""
        if self._closed:
            return
        self._closed = True
        if self._trace:
            if self.spec.trace_path:
                trace.save(self.spec.trace_path,
                           process_name=self.process_name)
            trace.disable()
        if self.metrics is not None:
            self.metrics.close()
        if self.audit is not None:
            self.audit.close()

    def __enter__(self) -> "ObsSession":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
