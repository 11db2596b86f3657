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

``device_span(...)`` is a span that also times the device work its block
queues: enabled and with CUDA initialised, it records a timing
``torch.cuda.Event`` on the current stream at enter and at exit, beside
the host span. The pairs stay pending (nothing waits for the device on
the hot path) until ``device_events()`` synchronises once and resolves
them onto the tracer's own clock (``perf_counter`` microseconds, the
host spans' clock) through two anchors: an event recorded at ``enable()``
and one at resolution, each on an idle stream between two host clock
reads. Between the anchors the map is linear, so drift between the GPU's
timer and the host clock is corrected. ``events()`` holds host events
only; ``to_dict()``/``save()`` add the device ranges on a track of their
own and the anchors as metadata.

Ownership: instrumented library code uses the module-global tracer via
``span``/``counter``/``instant``; ``repro_torch.monitoring.session.ObsSession``
(the ``obs`` spec axis) enables it for the duration of a run and writes the
trace on close. Tests can also drive a private ``Tracer`` instance.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional

#: Chrome-trace ``pid`` of the device-range track (no host process's).
DEVICE_PID = 1 << 30


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


class _DeviceSpan(_Span):
    """A live span that also brackets its block with timing events on the
    current CUDA stream, resolved later by ``Tracer.device_events``."""

    __slots__ = ("_start",)

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        self._start = self._tracer._record()
        return self

    def __exit__(self, *exc):
        end = self._tracer._record() if self._start is not None else None
        super().__exit__(*exc)
        if end is not None:
            self._tracer._add_pending(self._name, self._start, end,
                                      self._args)
        return False


def _cuda():
    """``torch`` where CUDA is initialised in this process, else None."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return None
    return torch


def _clock_anchor(torch) -> tuple:
    """(event, host µs): an event recorded on an idle stream, and the
    midpoint of the host clock reads around its record."""
    torch.cuda.synchronize()
    ev = torch.cuda.Event(enable_timing=True)
    h0 = time.perf_counter_ns()
    ev.record()
    h1 = time.perf_counter_ns()
    return ev, (h0 + h1) / 2e3


class Tracer:
    """In-memory trace-event collector (one per process is the norm)."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self._events: List[dict] = []
        self._lock = threading.Lock()
        self._pid = os.getpid()
        self._anchor: Optional[tuple] = None   # (event, host µs)
        self._pending: List[tuple] = []        # unresolved device ranges
        self._device: List[dict] = []          # resolved device ranges
        self._anchors: List[dict] = []         # each resolution's anchors
        self._device_name = ""

    # ---- recording ----

    def span(self, name: str, **args):
        """Context manager timing a block; no-op (shared singleton, zero
        allocation) when disabled."""
        if not self.enabled:
            return _NOOP
        return _Span(self, name, args)

    def device_span(self, name: str, **args):
        """``span`` that also times on the device the work its block
        queues (see the module docstring)."""
        if not self.enabled:
            return _NOOP
        return _DeviceSpan(self, name, args)

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

    def anchor_clock(self) -> None:
        """Record the opening anchor of the device clock, where CUDA is
        initialised and none is held (``enable()`` calls it; the first
        device range does where CUDA came up later)."""
        torch = _cuda()
        if torch is not None and self._anchor is None:
            self._anchor = _clock_anchor(torch)
            self._device_name = (f"cuda:{torch.cuda.current_device()} "
                                 f"{torch.cuda.get_device_name()}")

    def _record(self):
        torch = _cuda()
        if torch is None:
            return None
        if self._anchor is None:
            self.anchor_clock()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _add_pending(self, name: str, start, end,
                     args: Dict[str, Any]) -> None:
        with self._lock:
            self._pending.append((name, start, end, threading.get_ident(),
                                  args))

    def device_events(self) -> List[dict]:
        """The device ranges as complete events on the tracer's clock,
        sorted by start. Resolves the pending ones first: one synchronise,
        then each event's time since the opening anchor, mapped linearly
        through the opening anchor and a closing one recorded now (which
        opens the next resolution)."""
        with self._lock:
            pending, self._pending = self._pending, []
        if pending:
            torch = sys.modules["torch"]
            (a0, h0), (a1, h1) = self._anchor, _clock_anchor(torch)
            span_ms = a0.elapsed_time(a1)
            scale = (h1 - h0) / (span_ms * 1e3) if span_ms > 0 else 1.0
            host = lambda ev: h0 + a0.elapsed_time(ev) * 1e3 * scale
            out = []
            for name, start, end, tid, args in pending:
                ts = host(start)
                out.append({"name": name, "ph": "X", "ts": ts,
                            "dur": host(end) - ts, "pid": DEVICE_PID,
                            "tid": tid, "args": args})
            with self._lock:
                self._device.extend(out)
                self._device.sort(key=lambda e: e["ts"])
                self._anchors.append({"host_us": [h0, h1],
                                      "device_ms": span_ms})
                self._anchor = (a1, h1)
        with self._lock:
            return list(self._device)

    # ---- lifecycle / export ----

    def clear(self) -> None:
        with self._lock:
            self._events = []
            self._pending, self._device, self._anchors = [], [], []
            self._anchor = None

    @property
    def num_events(self) -> int:
        return len(self._events)

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def to_dict(self, process_name: str = "repro") -> dict:
        """Chrome trace-event JSON object (Perfetto-loadable). Device
        ranges, where there are any, ride on a track of their own, and
        the device clock's anchors under ``otherData``."""
        meta = [{"name": "process_name", "ph": "M", "pid": self._pid,
                 "tid": 0, "args": {"name": process_name}}]
        device = self.device_events()
        out = {"traceEvents": meta + self.events(), "displayTimeUnit": "ms"}
        if device:
            out["traceEvents"] += [{
                "name": "process_name", "ph": "M", "pid": DEVICE_PID,
                "tid": 0, "args": {"name": self._device_name}}] + device
            out["otherData"] = {"device_clock_anchors": list(self._anchors)}
        return out

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
    _GLOBAL.anchor_clock()


def disable() -> None:
    _GLOBAL.enabled = False


def span(name: str, **args):
    """``with span("schedule", job=m): ...`` — global-tracer span. The
    disabled fast path is one attribute check + a shared singleton."""
    if not _GLOBAL.enabled:
        return _NOOP
    return _Span(_GLOBAL, name, args)


def device_span(name: str, **args):
    """``with device_span("local_sgd", job=m): ...`` — global-tracer span
    that also times its block's device work; the same disabled fast path
    as ``span``."""
    if not _GLOBAL.enabled:
        return _NOOP
    return _DeviceSpan(_GLOBAL, name, args)


def counter(name: str, value: float, **args) -> None:
    _GLOBAL.counter(name, value, **args)


def instant(name: str, **args) -> None:
    _GLOBAL.instant(name, **args)


def save(path: str, process_name: str = "repro") -> None:
    _GLOBAL.save(path, process_name)


def clear() -> None:
    _GLOBAL.clear()
