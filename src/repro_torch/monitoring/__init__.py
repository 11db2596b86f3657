"""Monitoring: the span tracer (``trace``) and the event bus (``bus``) the
engine publishes to. Metrics, audit and the ``obs`` session are ROADMAP
module 8."""

from repro_torch.monitoring.bus import EventBus
from repro_torch.monitoring.trace import Tracer, span

__all__ = ["EventBus", "Tracer", "span"]
