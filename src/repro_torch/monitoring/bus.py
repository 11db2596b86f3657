"""Tiny synchronous pub/sub event bus wiring engine/serve lifecycle events
to monitoring sinks.

The engine publishes ``round`` (the finished ``RoundRecord``),
``round_begin`` (launch-time dict: job, round index, realized cohort size,
estimated cost) and ``job_done``; the scheduler service adds
``serve.admit`` / ``serve.depart`` / ``serve.queue_wait`` /
``serve.churn`` / ``serve.checkpoint``. ``MetricsLogger.on_round`` and
``SchedulerAudit.on_round`` are the shipped sinks
(``repro_torch.monitoring.session.ObsSession`` subscribes them
declaratively from the spec's ``obs`` axis); anything callable can
subscribe.

Sinks are isolated: a raising sink is counted (``bus.errors``) and warned
about once per (topic, sink), never allowed to break the publishing hot
path — monitoring must not take down the run it observes.
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, Dict, List, Tuple

Sink = Callable[[Any], None]


class EventBus:
    def __init__(self):
        self._subs: Dict[str, List[Sink]] = {}
        self.errors = 0
        self._warned: set = set()

    def subscribe(self, topic: str, sink: Sink) -> Sink:
        """Register ``sink`` for ``topic``; returns the sink (decorator
        friendly). Sinks fire synchronously in subscription order."""
        self._subs.setdefault(topic, []).append(sink)
        return sink

    def unsubscribe(self, topic: str, sink: Sink) -> bool:
        """Remove ``sink`` from ``topic``; True if it was subscribed."""
        subs = self._subs.get(topic, [])
        if sink in subs:
            subs.remove(sink)
            return True
        return False

    def topics(self) -> Tuple[str, ...]:
        return tuple(sorted(t for t, subs in self._subs.items() if subs))

    def publish(self, topic: str, payload: Any = None) -> int:
        """Deliver ``payload`` to every sink of ``topic``; returns the number
        of successful deliveries. Sink exceptions are swallowed (warned once,
        counted) so monitoring can never crash the engine."""
        delivered = 0
        for sink in self._subs.get(topic, ()):
            try:
                sink(payload)
                delivered += 1
            except Exception as e:  # noqa: BLE001 - sink isolation by design
                self.errors += 1
                key = (topic, id(sink))
                if key not in self._warned:
                    self._warned.add(key)
                    warnings.warn(
                        f"event-bus sink {getattr(sink, '__name__', sink)!r} "
                        f"failed on topic {topic!r}: {e!r} (suppressing "
                        "further warnings for this sink)", RuntimeWarning)
        return delivered
