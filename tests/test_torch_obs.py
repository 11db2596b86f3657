"""The port's observability axis (``repro_torch.monitoring``: ``ObsSession``,
``MetricsLogger``, ``SchedulerAudit``, ``report`` and its CLI) against the
reference's ``repro.monitoring``, on the CPU.

Tolerance: none. The same run in both packages must write the same
metrics JSONL (every field but the wall-clock ``t``) and the same audit log,
line for line, publish the same ``serve.*`` events, and trace the same span
names the same number of times (one ``schedule`` and one ``aggregate`` per
record). Span durations are wall clock and are not compared; the trace's
span coverage is not gated either, since it is a ratio of wall-clock spans
that moves with the host's load.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.experiment import presets as ref_presets  # noqa: E402
from repro.monitoring import report as ref_rpt  # noqa: E402
from repro.serve import service as ref_service  # noqa: E402
from repro_torch.experiment import presets  # noqa: E402
from repro_torch.experiment.spec import (ExperimentSpec, JobSpec,  # noqa: E402
                                         PoolSpec)
from repro_torch.monitoring import ObsSession, ObsSpec  # noqa: E402
from repro_torch.monitoring import report as rpt  # noqa: E402
from repro_torch.monitoring import trace as trace_mod  # noqa: E402
from repro_torch.monitoring.__main__ import main as monitoring_cli  # noqa: E402
from repro_torch.serve.service import SchedulerService  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def obs_paths(tmp_path, side):
    return dict(trace_path=str(tmp_path / f"{side}-trace.json"),
                metrics_path=str(tmp_path / f"{side}-metrics.jsonl"),
                audit_path=str(tmp_path / f"{side}-audit.jsonl"))


def span_counts(events):
    counts = {}
    for ev in events:
        if ev.get("ph") in ("X", "i"):
            key = (ev["ph"], ev["name"])
            counts[key] = counts.get(key, 0) + 1
    return counts


def without_t(rows):
    return [{k: v for k, v in r.items() if k != "t"} for r in rows]


def assert_obs_outputs_agree(ref, port, n_records):
    """Metrics (all but ``t``) and audit rows equal line for line; the same
    span names, each as often, one schedule and aggregate per record."""
    ref_metrics = ref_rpt.load_metrics(ref["metrics_path"])
    port_metrics = rpt.load_metrics(port["metrics_path"])
    assert len(port_metrics) == n_records > 0
    assert without_t(port_metrics) == without_t(ref_metrics)
    with open(ref["audit_path"]) as fa, open(port["audit_path"]) as fb:
        assert fb.read().splitlines() == fa.read().splitlines()
    ref_spans = span_counts(ref_rpt.load_trace(ref["trace_path"]))
    port_spans = span_counts(rpt.load_trace(port["trace_path"]))
    assert port_spans == ref_spans
    assert port_spans[("X", "schedule")] == n_records
    assert port_spans[("X", "aggregate")] == n_records


# ---- the obs axis on an experiment run --------------------------------

@pytest.mark.parametrize("scheduler", ["greedy", "random"])
def test_quickstart_obs_outputs_match_reference(tmp_path, scheduler):
    ref_spec = ref_presets.get_preset("quickstart", scheduler=scheduler,
                                      max_rounds=8)
    spec = presets.get_preset("quickstart", scheduler=scheduler,
                              max_rounds=8)
    ref, port = obs_paths(tmp_path, "ref"), obs_paths(tmp_path, "port")
    ref_res = ref_spec.replace(obs=ref).run()
    res = spec.replace(obs=port).run(device="cpu")
    assert not trace_mod.enabled()       # the session released the tracer
    assert len(res.records) == len(ref_res.records)
    assert_obs_outputs_agree(ref, port, len(res.records))
    audit = [json.loads(line) for line in open(port["audit_path"])]
    assert all(a["scheduler"] == scheduler for a in audit)
    for phase in rpt.ENGINE_PHASES + ("engine_run",):
        assert phase in rpt.phase_stats(rpt.load_trace(port["trace_path"]))


def test_service_obs_outputs_and_bus_match_reference(tmp_path):
    """``slo-overload`` (rungs, breakers, sheds) through both services with
    the obs axis on and a checkpoint every 4 events: the same metrics,
    audit rows, span names and counts (``rescore``, ``serve_advance``,
    ``handle_event``, ``checkpoint_write``, ``queue_wait``), and the same
    ``serve.*`` events on the bus."""
    kw = dict(scheduler="random", horizon=5_000.0, num_devices=30)
    ref, port = obs_paths(tmp_path, "ref"), obs_paths(tmp_path, "port")
    ref_spec = ref_presets.get_preset("slo-overload", **kw).replace(obs=ref)
    spec = presets.get_preset("slo-overload", **kw).replace(obs=port)
    published = []
    for make, s, extra, ck in (
            (ref_service.SchedulerService, ref_spec, {}, "ref-ck"),
            (SchedulerService, spec, {"device": "cpu"}, "port-ck")):
        svc = make(s, checkpoint_dir=str(tmp_path / ck), checkpoint_every=4,
                   **extra)
        seen = []
        bus = svc.engine.events
        for topic in ("serve.admit", "serve.depart", "serve.churn",
                      "serve.shed", "serve.queue_wait", "serve.degrade",
                      "serve.breaker", "serve.checkpoint", "serve.stall",
                      "serve.recovered", "serve.agg_failed", "job_done"):
            bus.subscribe(topic, lambda p, topic=topic: seen.append(
                (topic, p)))
        svc.run()
        published.append(seen)
        n_records = len(svc.engine.records)
    assert published[0] == published[1]
    topics = {t for t, _ in published[1]}
    assert {"serve.admit", "serve.degrade", "serve.checkpoint"} <= topics
    assert_obs_outputs_agree(ref, port, n_records)
    spans = span_counts(rpt.load_trace(port["trace_path"]))
    for name in ("rescore", "serve_advance", "handle_event",
                 "checkpoint_write"):
        assert spans[("X", name)] > 0, name
    slo = rpt.slo_summary(rpt.load_metrics(port["metrics_path"]))
    assert slo["degraded_decisions"] > 0
    assert slo == ref_rpt.slo_summary(ref_rpt.load_metrics(
        ref["metrics_path"]))


def tiny_spec(**obs):
    return ExperimentSpec(
        jobs=(JobSpec(name="j0", max_rounds=6, target_metric=2.0),),
        pool=PoolSpec(num_devices=12), scheduler="greedy", n_sel=3,
        obs=ObsSpec(**obs))


def test_obs_disabled_run_is_bitwise_identical(tmp_path):
    plain = tiny_spec().run(device="cpu")
    traced = tiny_spec(trace_path=str(tmp_path / "t.json"),
                       metrics_path=str(tmp_path / "m.jsonl"),
                       audit_path=str(tmp_path / "a.jsonl")).run(device="cpu")
    assert len(plain.records) == len(traced.records) > 0
    for a, b in zip(plain.records, traced.records):
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        for k, va in da.items():
            if isinstance(va, np.ndarray):
                assert np.array_equal(va, db[k]), k
            else:
                assert va == db[k], k


def test_engine_bus_topics():
    ex = tiny_spec(enabled=True).build(device="cpu")
    eng = ex.engine
    assert isinstance(eng.obs, ObsSession) and eng.events is not None
    begun, rounds, done = [], [], []
    eng.events.subscribe("round_begin", begun.append)
    eng.events.subscribe("round", rounds.append)
    eng.events.subscribe("job_done", done.append)
    ex.run()
    assert len(begun) == len(rounds) > 0
    assert [d["job"] for d in done] == [0]
    assert all(r.job == 0 for r in rounds)
    assert not trace_mod.enabled()


def test_session_closes_on_a_failed_run(tmp_path):
    """``Experiment.run`` finalizes the obs axis even when the run dies:
    the trace is written and the tracer released."""
    ex = tiny_spec(trace_path=str(tmp_path / "t.json")).build(device="cpu")

    def broken(job_id, device_ids, round_idx):
        raise RuntimeError("boom")

    ex.engine.runtime.run_round = broken
    with pytest.raises(RuntimeError, match="boom"):
        ex.run()
    assert not trace_mod.enabled()
    assert "schedule" in rpt.phase_stats(rpt.load_trace(
        str(tmp_path / "t.json")))


def test_metrics_logger_batches_flushes(tmp_path):
    from repro_torch.monitoring import MetricsLogger, StepTimer

    path = tmp_path / "m.jsonl"
    with MetricsLogger(str(path), flush_every=3) as log:
        for i in range(4):
            log.log(i, {"loss": float(i)})
    rows = rpt.load_metrics(str(path))
    assert [r["step"] for r in rows] == [0, 1, 2, 3]
    with pytest.raises(ValueError):
        MetricsLogger(str(path), flush_every=0)
    timer = StepTimer()
    for _ in range(3):
        with timer:
            pass
    assert timer.ema_s is not None and timer.stragglers >= 0


# ---- the report and its CLI --------------------------------------------

def test_report_functions_match_reference(tmp_path):
    """Every report function gives the reference's answer on the same
    trace and metrics files (a port run's)."""
    paths = obs_paths(tmp_path, "port")
    presets.get_preset("quickstart", scheduler="greedy", max_rounds=6) \
        .replace(obs=paths).run(device="cpu")
    events = rpt.load_trace(paths["trace_path"])
    assert events == ref_rpt.load_trace(paths["trace_path"])
    stats = rpt.phase_stats(events)
    assert stats == ref_rpt.phase_stats(events)
    assert rpt.coverage(stats) == ref_rpt.coverage(stats)
    assert rpt.rounds_per_sec(stats) == ref_rpt.rounds_per_sec(stats)
    metrics = rpt.load_metrics(paths["metrics_path"])
    assert rpt.per_job_summary(metrics) == ref_rpt.per_job_summary(metrics)
    half = {k: dict(v, p50_ms=v["p50_ms"] / 2) for k, v in stats.items()}
    assert rpt.diff_phases(stats, half) == ref_rpt.diff_phases(stats, half)
    got = rpt.summarize(paths["trace_path"], paths["metrics_path"])
    exp = ref_rpt.summarize(paths["trace_path"], paths["metrics_path"])
    # The reference's jit recompile count has no counterpart in the port.
    assert got == {k: v for k, v in exp.items() if k != "recompiles"}


def test_report_cli_smoke(tmp_path, capsys):
    paths = obs_paths(tmp_path, "port")
    presets.get_preset("quickstart", scheduler="greedy", max_rounds=4) \
        .replace(obs=paths).run(device="cpu")
    out_json = tmp_path / "report.json"
    assert monitoring_cli(["report", paths["trace_path"], "--metrics",
                           paths["metrics_path"], "--diff",
                           paths["trace_path"], "--json",
                           str(out_json)]) == 0
    text = capsys.readouterr().out
    assert "engine_run" in text and "engine span coverage" in text
    assert "per-job summary" in text and "ratio" in text
    assert "phases" in json.loads(out_json.read_text())
    empty = tmp_path / "empty.json"
    empty.write_text(json.dumps({"traceEvents": []}))
    assert monitoring_cli(["report", str(empty)]) == 1
