"""Scheduler decision audit log.

Every scheduling decision is reconstructable: which devices were scheduled,
what it cost, the ESTIMATED vs realized cost (``est_cost`` is the
scheduler's Formula-2 estimate at decision time; ``cost - est_cost`` is the
residual the learned schedulers model), whether the round degraded to a
single-survivor aggregate, and the fairness state. Required for debugging
production scheduling regressions ("why did job 3 starve yesterday?") and
doubles as the data source for offline scheduler evaluation / RLDS
re-training.

``on_round`` is an event-bus sink (``repro_torch.monitoring.bus``): subscribe it
to the engine's ``round`` topic — ``repro_torch.monitoring.session.ObsSession``
wires this from the spec's ``obs.audit_path`` knob — or pass it directly as
``engine.run(on_round=audit.on_round)``. Context-manager use closes the
file handle deterministically.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np


class SchedulerAudit:
    def __init__(self, path: str, scheduler: Optional[str] = None):
        """``scheduler``: registry name stamped on every line so mixed-log
        analysis can attribute decisions (e.g. A/B across schedulers)."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        # Line-buffered: each decision lands on disk immediately (the audit
        # log is the crash post-mortem input, unlike the batched metrics).
        self._f = open(path, "a", buffering=1)
        self.scheduler = scheduler

    def on_round(self, rec) -> None:
        self._f.write(json.dumps({
            "job": rec.job,
            "round": rec.round_idx,
            "scheduler": self.scheduler,
            "t_start": rec.t_start,
            "t_end": rec.t_end,
            "round_time": rec.round_time,
            "cost": rec.cost,
            "est_cost": None if rec.est_cost is None else float(rec.est_cost),
            "fairness": rec.fairness,
            "degraded": bool(rec.degraded),
            "rung": getattr(rec, "rung", None),
            "decision_ms": (None if getattr(rec, "decision_ms", None) is None
                            else float(rec.decision_ms)),
            "loss": rec.loss,
            "accuracy": rec.accuracy,
            "devices": np.asarray(rec.device_ids).tolist(),
            "dropped": np.asarray(rec.dropped).tolist(),
        }) + "\n")

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def __enter__(self) -> "SchedulerAudit":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


def replay(path: str):
    """Load an audit log back into RoundRecord-like dicts."""
    out = []
    with open(path) as f:
        for line in f:
            if line.strip():
                out.append(json.loads(line))
    return out
