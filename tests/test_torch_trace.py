"""The port's tracer on the CPU: ``device_span``'s disabled fast path, its
host span alone where CUDA is not initialised, and its device ranges
resolved onto the host clock through a stand-in for ``torch.cuda.Event``
whose timer runs at another rate and origin than the host clock."""

import types

import pytest

torch = pytest.importorskip("torch")

from repro_torch.monitoring import report as rpt  # noqa: E402
from repro_torch.monitoring import trace as trace_mod  # noqa: E402

DRIFT = 1e-3          # the stand-in timer runs 0.1% fast
ORIGIN_MS = 7_000.0   # and starts elsewhere


class FakeClock:
    """``perf_counter_ns`` that moves 1 us a read, and jumps on request."""

    def __init__(self):
        self.now = 10 ** 9

    def perf_counter_ns(self):
        self.now += 1_000
        return self.now


def fake_cuda(monkeypatch, clock):
    """Stand-ins for the CUDA calls the tracer makes; returns the list of
    events recorded, each with the host time of its record."""
    recorded = []

    class Event:
        def __init__(self, enable_timing=False):
            assert enable_timing
            self.ms = None

        def record(self):
            self.host_ns = clock.now
            self.ms = ORIGIN_MS + clock.now * (1 + DRIFT) / 1e6
            recorded.append(self)

        def elapsed_time(self, other):
            return other.ms - self.ms

    monkeypatch.setattr(trace_mod, "time", types.SimpleNamespace(
        perf_counter_ns=clock.perf_counter_ns))
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "Fake GPU")
    return recorded


def test_disabled_device_span_is_the_shared_noop():
    assert not trace_mod.enabled()
    assert trace_mod.device_span("local_sgd", job=1) is trace_mod._NOOP
    assert trace_mod.Tracer().device_span("x") is trace_mod._NOOP


def test_without_cuda_a_device_span_is_the_host_span_alone():
    assert not torch.cuda.is_initialized()
    tr = trace_mod.Tracer(enabled=True)
    with tr.device_span("gather", job=0):
        pass
    (ev,) = tr.events()
    assert (ev["name"], ev["ph"], ev["args"]) == ("gather", "X", {"job": 0})
    assert tr.device_events() == []
    assert "otherData" not in tr.to_dict()


def test_device_ranges_resolve_onto_the_host_clock(monkeypatch):
    clock = FakeClock()
    recorded = fake_cuda(monkeypatch, clock)
    tr = trace_mod.Tracer(enabled=True)
    tr.anchor_clock()
    with tr.device_span("fused_round", jobs=2):
        with tr.device_span("local_sgd", job=0, round=3):
            clock.now += 10 ** 10            # 10 s of host time
        with tr.device_span("eval", job=0, round=3):
            pass
    clock.now += 2 * 10 ** 10
    assert len(tr.events()) == 3 and len(tr._pending) == 3
    dev = tr.device_events()
    # Each range on the host clock where its events were recorded: the
    # 0.1% drift (30 ms over the 30 s) is taken out by the two anchors, to
    # the half microsecond that the anchors' host reads bracket.
    # Recorded: the anchor, fused_round's start, local_sgd's start and
    # end, eval's start and end, fused_round's end, the closing anchor.
    starts = [recorded[i].host_ns for i in (1, 2, 4)]
    assert [e["name"] for e in dev] == ["fused_round", "local_sgd", "eval"]
    assert [e["ts"] for e in dev] == pytest.approx(
        [ns / 1e3 for ns in starts], abs=1.0)
    sgd = dev[1]
    assert sgd["dur"] == pytest.approx(1e7, abs=1.0)  # us
    assert sgd["args"] == {"job": 0, "round": 3}
    assert all(e["pid"] == trace_mod.DEVICE_PID for e in dev)
    outer = dev[0]
    for inner in dev[1:]:
        assert outer["ts"] <= inner["ts"]
        assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    # events() holds the host spans alone; the device track and the
    # anchors ride in the export.
    assert all(e["pid"] == tr._pid for e in tr.events())
    d = tr.to_dict()
    names = {(e["pid"], e["name"]) for e in d["traceEvents"]}
    assert (trace_mod.DEVICE_PID, "local_sgd") in names
    assert (tr._pid, "local_sgd") in names
    (anchors,) = d["otherData"]["device_clock_anchors"]
    assert anchors["device_ms"] == pytest.approx(
        (anchors["host_us"][1] - anchors["host_us"][0]) / 1e3 * (1 + DRIFT),
        rel=1e-6)
    stats = rpt.phase_stats(d["traceEvents"])
    assert stats["local_sgd (device)"]["count"] == 1
    assert stats["local_sgd"]["count"] == 1
    # A second resolution starts from the first's closing anchor.
    with tr.device_span("fedavg"):
        pass
    assert [e["name"] for e in tr.device_events()][-1] == "fedavg"
    assert len(tr.to_dict()["otherData"]["device_clock_anchors"]) == 2


def test_clear_drops_pending_ranges(monkeypatch):
    fake_cuda(monkeypatch, FakeClock())
    tr = trace_mod.Tracer(enabled=True)
    with tr.device_span("local_sgd"):
        pass
    assert tr._pending and tr._anchor is not None
    tr.clear()
    assert tr.events() == [] and tr.device_events() == []
    assert tr._pending == [] and tr._anchor is None


def test_global_enable_anchors_the_device_clock(monkeypatch):
    fake_cuda(monkeypatch, FakeClock())
    tracer = trace_mod.get_tracer()
    tracer.clear()
    trace_mod.enable()
    try:
        assert tracer._anchor is not None
        with trace_mod.device_span("gather", job=1):
            pass
    finally:
        trace_mod.disable()
    try:
        assert [e["name"] for e in tracer.device_events()] == ["gather"]
        assert [e["name"] for e in tracer.events()] == ["gather"]
    finally:
        tracer.clear()
