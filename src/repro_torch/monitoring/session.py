"""The ``obs`` experiment axis: ``ObsSpec``, so that specs round-trip.

Only the dataclass is ported. ``ObsSession``, which wires the tracer, the
metrics and audit sinks to a run, is ROADMAP module 8: building a spec
whose ``obs`` is active raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ObsSpec:
    """Observability axis: where (and whether) a run reports. Any non-None
    path implies ``enabled``."""

    enabled: bool = False
    trace_path: Optional[str] = None
    metrics_path: Optional[str] = None
    audit_path: Optional[str] = None
    flush_every: int = 1

    @property
    def active(self) -> bool:
        return bool(self.enabled or self.trace_path or self.metrics_path
                    or self.audit_path)
