"""Deterministic, replayable fault injection (the resilience layer).

``FaultSpec`` declares WHAT goes wrong (crash/dropout/straggler/domain/
corruption rates, quarantine backoff, round deadline); ``FaultEngine``
realizes it as counter-keyed per-round draws any layer can replay
independently. See ``repro_torch.faults.spec`` for the taxonomy.
"""

from repro_torch.faults.engine import FaultEngine
from repro_torch.faults.spec import CORRUPT_MODES, FaultSpec

__all__ = ["FaultSpec", "FaultEngine", "CORRUPT_MODES"]
