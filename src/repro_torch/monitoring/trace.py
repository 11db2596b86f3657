"""Zero-cost-when-disabled span tracer with Chrome/Perfetto JSON export.

The repo's headline claims are about TIME — where a round's wall-clock goes
(scheduler search vs dispatch vs train step vs aggregation vs eval) —
so the hot paths carry ``span(...)`` markers that compile down to a single
attribute check when tracing is off:

    from repro_torch.monitoring.trace import span

    with span("schedule", job=m):
        plan = scheduler.schedule(ctx)

Enabled, each span records one Chrome trace-event "complete" event
(``ph="X"``: name, ts, dur, pid, tid, args) into an in-memory buffer;
``save(path)`` writes ``{"traceEvents": [...]}`` which loads directly in
Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``. Spans nest by
construction — complete events on the same thread track nest by ts/dur in
the viewer — and are thread-safe (one buffer, GIL-atomic appends; tid
disambiguates tracks).

Disabled (the default), ``span()`` returns a shared no-op context manager
without allocating anything, and ``counter``/``instant`` return
immediately: no RNG is touched, no arrays are built, so traced and
untraced runs execute the SAME computation.

Ownership: instrumented library code uses the module-global tracer via
``span``/``counter``/``instant``; ``repro_torch.monitoring.session.ObsSession``
(the ``obs`` spec axis) enables it for the duration of a run and writes the
trace on close. Tests can also drive a private ``Tracer`` instance.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List


class _NoopSpan:
    """Shared do-nothing context manager returned when tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


class _Span:
    """A live span: records one complete event on exit."""

    __slots__ = ("_tracer", "_name", "_args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, args: Dict[str, Any]):
        self._tracer = tracer
        self._name = name
        self._args = args

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self._tracer._emit_complete(self._name, self._t0,
                                    time.perf_counter_ns(), self._args)
        return False


class Tracer:
    """In-memory trace-event collector (one per process is the norm)."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self._events: List[dict] = []
        self._lock = threading.Lock()
        self._pid = os.getpid()

    # ---- recording ----

    def span(self, name: str, **args):
        """Context manager timing a block; no-op (shared singleton, zero
        allocation) when disabled."""
        if not self.enabled:
            return _NOOP
        return _Span(self, name, args)

    def counter(self, name: str, value: float, **args) -> None:
        """Chrome counter event (renders as a stacked track in Perfetto)."""
        if not self.enabled:
            return
        with self._lock:
            self._events.append({
                "name": name, "ph": "C",
                "ts": time.perf_counter_ns() / 1e3,
                "pid": self._pid, "tid": threading.get_ident(),
                "args": {name: value, **args}})

    def instant(self, name: str, **args) -> None:
        """Chrome instant event (a vertical marker; thread-scoped)."""
        if not self.enabled:
            return
        with self._lock:
            self._events.append({
                "name": name, "ph": "i", "s": "t",
                "ts": time.perf_counter_ns() / 1e3,
                "pid": self._pid, "tid": threading.get_ident(),
                "args": args})

    def _emit_complete(self, name: str, t0_ns: int, t1_ns: int,
                       args: Dict[str, Any]) -> None:
        with self._lock:
            self._events.append({
                "name": name, "ph": "X",
                "ts": t0_ns / 1e3, "dur": (t1_ns - t0_ns) / 1e3,
                "pid": self._pid, "tid": threading.get_ident(),
                "args": args})

    # ---- lifecycle / export ----

    def clear(self) -> None:
        with self._lock:
            self._events = []

    @property
    def num_events(self) -> int:
        return len(self._events)

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def to_dict(self, process_name: str = "repro") -> dict:
        """Chrome trace-event JSON object (Perfetto-loadable)."""
        meta = [{"name": "process_name", "ph": "M", "pid": self._pid,
                 "tid": 0, "args": {"name": process_name}}]
        return {"traceEvents": meta + self.events(),
                "displayTimeUnit": "ms"}

    def save(self, path: str, process_name: str = "repro") -> None:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_dict(process_name), f)
            f.write("\n")


# ---- the module-global tracer the instrumented hot paths talk to ----

_GLOBAL = Tracer()


def get_tracer() -> Tracer:
    return _GLOBAL


def enabled() -> bool:
    return _GLOBAL.enabled


def enable() -> None:
    _GLOBAL.enabled = True


def disable() -> None:
    _GLOBAL.enabled = False


def span(name: str, **args):
    """``with span("schedule", job=m): ...`` — global-tracer span. The
    disabled fast path is one attribute check + a shared singleton."""
    if not _GLOBAL.enabled:
        return _NOOP
    return _Span(_GLOBAL, name, args)


def counter(name: str, value: float, **args) -> None:
    _GLOBAL.counter(name, value, **args)


def instant(name: str, **args) -> None:
    _GLOBAL.instant(name, **args)


def save(path: str, process_name: str = "repro") -> None:
    _GLOBAL.save(path, process_name)


def clear() -> None:
    _GLOBAL.clear()
