"""Structured metrics logging (JSONL) + step timing.

Production loops emit one JSONL record per step; dashboards/tools tail the
file. ``flush_every`` batches writes: the file is opened BLOCK-buffered and
flushed explicitly every N records (N=1, the default, keeps the historical
crash-safe line-at-a-time behavior). ``close()`` always flushes the tail;
both the logger and ``SchedulerAudit`` are context managers so no run leaks
an open file handle. ``StepTimer`` keeps an EMA of step time and flags
stragglers (steps > k x EMA) — the host-side counterpart of the engine's
device-level straggler mitigation.

``MetricsLogger.on_round`` is the engine sink: subscribe it to an
``EventBus`` ``round`` topic (``repro_torch.monitoring.session`` does this from
the spec's ``obs`` axis) and every finished ``RoundRecord`` becomes one
JSONL row — the input half of ``python -m repro_torch.monitoring report``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    def __init__(self, path: str, flush_every: int = 1):
        if flush_every < 1:
            raise ValueError(f"flush_every must be >= 1, got {flush_every}")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        # Block-buffered on purpose: the explicit flush below is the ONLY
        # flush cadence, so flush_every genuinely batches small writes
        # (buffering=1 would flush every line and make the knob dead code).
        self._f = open(path, "a")
        self._flush_every = flush_every
        self._n = 0

    def log(self, step: int, metrics: Dict[str, Any], **extra) -> None:
        rec = {"step": step, "t": time.time(), **metrics, **extra}
        self._f.write(json.dumps(rec, default=float) + "\n")
        self._n += 1
        if self._n % self._flush_every == 0:
            self._f.flush()

    def on_round(self, rec) -> None:
        """Event-bus sink: one JSONL row per finished ``RoundRecord``."""
        self.log(rec.round_idx, {
            "job": rec.job, "t_start": rec.t_start, "t_end": rec.t_end,
            "round_time": rec.round_time, "cost": rec.cost,
            "fairness": rec.fairness, "loss": rec.loss,
            "accuracy": rec.accuracy, "est_cost": rec.est_cost,
            "degraded": bool(rec.degraded),
            "rung": getattr(rec, "rung", None),
            "decision_ms": getattr(rec, "decision_ms", None),
            "n_devices": int(len(rec.device_ids)),
            "n_dropped": int(len(rec.dropped))})

    def flush(self) -> None:
        if not self._f.closed:
            self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


class StepTimer:
    """EMA step timer with straggler detection."""

    def __init__(self, ema: float = 0.9, straggler_factor: float = 3.0):
        self.ema_s: Optional[float] = None
        self._alpha = ema
        self._factor = straggler_factor
        self._t0: Optional[float] = None
        self.stragglers = 0

    def __enter__(self):
        self._t0 = time.time()
        return self

    def __exit__(self, *exc):
        dt = time.time() - self._t0
        if self.ema_s is not None and dt > self._factor * self.ema_s:
            self.stragglers += 1
        self.ema_s = dt if self.ema_s is None else (
            self._alpha * self.ema_s + (1 - self._alpha) * dt)
        self.last_s = dt
        return False
