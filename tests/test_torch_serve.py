"""The port's scheduler service (``repro_torch.serve``) against the
reference's ``repro.serve``, on the CPU.

Tolerance: none. numpy drives both services (traffic, engine, the host
schedulers, resilience), so records, counts, tenant metrics and rescore
costs compare bit for bit; BODS on its host search compares under the
near-tie rule of ``test_torch_paper_schedulers`` (a decision may split
only where the scores it picks between are within 1e-5, and the records
decided before it must agree). Covered:

- traffic: the same seeded stream, and a trace saved by the reference
  replays in the port to the reference's records;
- cross-package resume: the reference crashes (``SimulatedCrash``) and the
  port resumes, and the other way round, to the uninterrupted run;
- the port's own kill-and-resume (crashes at events 4, 5 and 11, fused
  BODS and random);
- the service: rescoring modes, the warm hand-off, the SLO stack (the
  watchdog's recovery included), the bounded retries, the CLI with
  ``--device cpu``.
"""

import dataclasses
import heapq
import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.experiment import presets as ref_presets  # noqa: E402
from repro.serve import service as ref_service  # noqa: E402
from repro.serve import traffic as ref_traffic  # noqa: E402
from repro_torch.checkpoint import committed_steps  # noqa: E402
from repro_torch.experiment import presets  # noqa: E402
from repro_torch.serve import RUNGS, traffic  # noqa: E402
from repro_torch.serve.metrics import ServiceMetrics  # noqa: E402
from repro_torch.serve.service import (SchedulerService,  # noqa: E402
                                       SimulatedCrash)

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def quiet():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        yield


def twin(preset, **kw):
    """The same preset from both packages (reference, port)."""
    return (ref_presets.get_preset(preset, **kw),
            presets.get_preset(preset, **kw))


def online(scheduler="random", with_faults=True, **kw):
    """The reference's resume-test spec: online-smoke at 40 devices and a
    short horizon, with faults."""
    kw = dict(dict(num_devices=40, horizon=8_000.0, interarrival=600.0),
              **kw)
    specs = twin("online-smoke", scheduler=scheduler, **kw)
    if with_faults:
        faults = dict(seed=3, dropout_rate=0.1, crash_rate=0.002,
                      straggler_rate=0.1, num_domains=4,
                      domain_outage_rate=0.02, corrupt_rate=0.05)
        specs = tuple(s.replace(faults=faults) for s in specs)
    return specs


def overload(scheduler="random"):
    return twin("slo-overload", scheduler=scheduler, horizon=5_000.0,
                num_devices=30)


def record_tuples(service):
    return [(r.job, r.round_idx, r.t_start, r.t_end, r.round_time, r.cost,
             r.fairness, r.loss, r.accuracy, r.est_cost, tuple(r.device_ids),
             tuple(r.dropped), tuple(r.corrupt_ids), tuple(r.failed_ids),
             bool(r.degraded), r.rung, r.decision_ms)
            for r in service.engine.records]


def record_rows(records):
    from repro_torch.experiment.spec import _record_to_dict

    return [_record_to_dict(r) for r in records]


def tenant_dicts(service):
    return {t: dataclasses.asdict(s) for t, s in service.metrics.tenants.items()}


def deterministic_summary(service):
    s = dict(service.resilience_summary() or {})
    s.pop("rung_latency_ms", None)   # wall clock: not replayable
    return s


def assert_services_agree(a, b):
    """Everything numpy decides: records, fairness counts, tenant metrics,
    counters, rescore costs and the resilience summary."""
    assert len(record_tuples(a)) > 0
    assert record_tuples(a) == record_tuples(b)
    np.testing.assert_array_equal(a.engine.counts, b.engine.counts)
    assert tenant_dicts(a) == tenant_dicts(b)
    sa, sb = a.metrics.to_state(), b.metrics.to_state()
    for s in (sa, sb):
        s.pop("latency_samples")
        s.pop("tenants")
    assert sa == sb
    assert a.rescore_costs == b.rescore_costs
    assert deterministic_summary(a) == deterministic_summary(b)
    assert a.engine.summary() == b.engine.summary()


def run_ref(spec, **kw):
    svc = ref_service.SchedulerService(spec, **kw)
    svc.run()
    return svc


def run_port(spec, **kw):
    svc = SchedulerService(spec, device="cpu", **kw)
    svc.run()
    return svc


# ---- traffic ---------------------------------------------------------------

@pytest.mark.parametrize("preset", ["online-smoke", "slo-overload"])
def test_poisson_trace_matches_reference(preset):
    ref, port = twin(preset)
    a = ref_traffic.trace_from_spec(ref.arrivals, len(ref.jobs), 60)
    b = traffic.trace_from_spec(port.arrivals, len(port.jobs), 60)
    assert [e.to_dict() for e in a] == [e.to_dict() for e in b]
    assert {e.kind for e in b} == set(traffic.EVENT_KINDS)


@pytest.mark.parametrize("scheduler", ["random", "greedy", "genetic"])
def test_reference_trace_replays_to_reference_records(tmp_path, scheduler):
    """A trace the reference saved, loaded by the port, is the same event
    stream, and the port's service runs it (``arrivals.mode="trace"``) to
    the reference's records."""
    ref, port = online(scheduler, with_faults=False)
    ref, port = (s.replace(search_backend="host") for s in (ref, port))
    path = str(tmp_path / "trace.json")
    events = ref_traffic.trace_from_spec(ref.arrivals, len(ref.jobs), 40)
    ref_traffic.save_trace(events, path)
    loaded = traffic.load_trace(path)
    assert [e.to_dict() for e in loaded] == [e.to_dict() for e in events]
    arrivals = {"mode": "trace", "trace_path": path}
    a = run_ref(ref.replace(arrivals=arrivals))
    b = run_port(port.replace(arrivals=arrivals))
    assert_services_agree(a, b)


def test_reference_trace_replays_bods_host(tmp_path, monkeypatch):
    """BODS on its host search through the same saved trace: the records
    agree up to the first decision that splits at a near tie."""
    from repro.core.schedulers import bods as ref_bods
    from repro_torch.core.schedulers import bods
    from test_torch_paper_schedulers import (Decisions, ScoreLog,
                                             assert_runs_agree, first_split)

    ref, port = online("bods", with_faults=False)
    ref, port = (s.replace(search_backend="host", scoring_backend="numpy")
                 for s in (ref, port))
    path = str(tmp_path / "trace.json")
    ref_traffic.save_trace(
        ref_traffic.trace_from_spec(ref.arrivals, len(ref.jobs), 40), path)
    arrivals = {"mode": "trace", "trace_path": path}
    ref_dec = Decisions(monkeypatch, ref_bods.BODSScheduler)
    port_dec = Decisions(monkeypatch, bods.BODSScheduler)
    ref_log = ScoreLog("argmax", ref_dec)
    port_log = ScoreLog("argmax", port_dec)
    monkeypatch.setattr(ref_bods, "np", ref_log)
    monkeypatch.setattr(bods, "np", port_log)
    a = run_ref(ref.replace(arrivals=arrivals)).engine.records
    b = run_port(port.replace(arrivals=arrivals)).engine.records
    assert len(port_log.scores) > 0
    split = first_split(ref_log.scores, port_log.scores, "argmax")
    assert_runs_agree(a, b, ref_dec.keys, port_dec.keys,
                      None if split is None else ref_log.at[split])


# ---- crash and resume across the two packages --------------------------

@pytest.mark.parametrize("crash_after", [4, 11])
@pytest.mark.parametrize("direction", ["reference-to-port",
                                       "port-to-reference"])
def test_cross_package_resume_bit_identical(tmp_path, direction,
                                            crash_after):
    """``slo-overload`` under ``random`` (breakers, the watchdog and the
    governor's rungs all fire): one package is killed mid-horizon, the
    other resumes its checkpoint, and the run ends as the uninterrupted
    one does."""
    ref_spec, port_spec = overload()
    base = run_ref(ref_spec)
    assert deterministic_summary(base)["degraded_rounds"] > 0
    ck = str(tmp_path / "ck")
    if direction == "reference-to-port":
        crashed = ref_service.SchedulerService(
            ref_spec, checkpoint_dir=ck, checkpoint_every=2,
            crash_after=crash_after)
        with pytest.raises(ref_service.SimulatedCrash):
            crashed.run()
        resumed = SchedulerService.resume(ck, device="cpu")
    else:
        crashed = SchedulerService(port_spec, device="cpu",
                                   checkpoint_dir=ck, checkpoint_every=2,
                                   crash_after=crash_after)
        with pytest.raises(SimulatedCrash):
            crashed.run()
        resumed = ref_service.SchedulerService.resume(ck)
    resumed.run()
    assert_services_agree(base, resumed)


def test_port_checkpoint_manifest_matches_reference(tmp_path):
    """The JSON half has the reference's keys and values at the same event
    boundary, and the array half the same leaf keys, dtypes and shapes."""
    from repro.serve.persistence import read_manifest_extra as ref_read
    from repro_torch.serve.persistence import read_manifest_extra

    ref_spec, port_spec = overload()
    for mk, spec, ck in ((ref_service.SchedulerService, ref_spec, "ref"),
                         (SchedulerService, port_spec, "port")):
        kw = {} if mk is ref_service.SchedulerService else {"device": "cpu"}
        svc = mk(spec, checkpoint_dir=str(tmp_path / ck),
                 checkpoint_every=3, crash_after=7, **kw)
        with pytest.raises(RuntimeError, match="crash_after"):
            svc.run()
    a = ref_read(str(tmp_path / "ref"))
    b = read_manifest_extra(str(tmp_path / "port"))
    a["metrics"].pop("latency_samples")
    b["metrics"].pop("latency_samples")
    assert a == b
    manifests = []
    for ck in ("ref", "port"):
        with open(tmp_path / ck / "step_0000000006" / "manifest.json") as f:
            manifests.append(json.load(f))
    for key in ("keys", "dtypes", "shapes"):
        assert manifests[0][key] == manifests[1][key], key


def test_checkpoint_spec_names_reference_backends():
    """The spec rides in the manifest with the reference's scoring-backend
    names, which ``from_dict`` maps back on the port's side."""
    from repro.experiment.spec import ExperimentSpec as RefSpec
    from repro_torch.experiment.spec import ExperimentSpec
    from repro_torch.serve.persistence import _spec_dict

    _, spec = overload()
    spec = spec.replace(scoring_backend="cuda",
                        fleet={"scoring_backend": "torch"})
    d = _spec_dict(spec)
    assert (d["scoring_backend"], d["fleet"]["scoring_backend"]) \
        == ("pallas", "jax")
    assert RefSpec.from_dict(d).effective_scoring_backend() == "pallas"
    assert ExperimentSpec.from_dict(d) == spec


# ---- the port's own kill-and-resume ------------------------------------

@pytest.mark.parametrize("scheduler", ["bods", "random"])
def test_crash_resume_bit_identical(scheduler, tmp_path):
    """As the reference's test of the same name: killed at an event that
    is a checkpoint boundary, one past it, and deep in the horizon; BODS
    runs its fused acquisition on the CPU."""
    _, spec = online(scheduler)
    base = run_port(spec)
    for crash_after in (4, 5, 11):
        ck = str(tmp_path / f"ck_{crash_after}")
        svc = SchedulerService(spec, device="cpu", checkpoint_dir=ck,
                               checkpoint_every=2, crash_after=crash_after)
        with pytest.raises(SimulatedCrash):
            svc.run()
        resumed = SchedulerService.resume(ck, device="cpu")
        resumed.run()
        assert_services_agree(base, resumed)


def test_degrading_service_survives_crash_bit_identically(tmp_path):
    _, spec = overload("greedy")
    base = run_port(spec)
    summary = deterministic_summary(base)
    assert summary["degraded_rounds"] > 0 and summary["shed_arrivals"] > 0
    assert all(r[-2] in RUNGS for r in record_tuples(base))
    ck = str(tmp_path / "ck")
    svc = SchedulerService(spec, device="cpu", checkpoint_dir=ck,
                           checkpoint_every=2, crash_after=5)
    with pytest.raises(SimulatedCrash):
        svc.run()
    resumed = SchedulerService.resume(ck, device="cpu")
    resumed.run()
    assert_services_agree(base, resumed)


def wedge_after(service, n):
    """After the ``n``-th traffic event, lose one live job's completion
    (its pending heap events and in-flight round): the job is wedged, and
    the watchdog must find it."""
    handle = service._handle
    seen = [0]

    def wedging(ev):
        handle(ev)
        seen[0] += 1
        if seen[0] == n and service._live:
            eng = service.engine
            job = min(service._live)
            eng._heap = [e for e in eng._heap if e[3] != job]
            heapq.heapify(eng._heap)
            eng._in_flight.pop(job, None)

    service._handle = wedging


def test_watchdog_recovery_matches_reference(tmp_path):
    """A wedged job trips the watchdog, which rebuilds the engine (on the
    service's device) and restores the newest checkpoint in place; the
    run then goes on as the reference's does."""
    ref_spec, port_spec = overload()
    ref = ref_service.SchedulerService(ref_spec, checkpoint_every=2,
                                       checkpoint_dir=str(tmp_path / "r"))
    port = SchedulerService(port_spec, device="cpu", checkpoint_every=2,
                            checkpoint_dir=str(tmp_path / "p"))
    for svc in (ref, port):
        wedge_after(svc, 9)
        svc.run()
    assert port.metrics.recoveries == ref.metrics.recoveries > 0
    assert str(port.engine.cost_model.device) == "cpu"
    assert_services_agree(ref, port)


def test_resume_restores_cursor_and_trace(tmp_path):
    _, spec = online("random")
    ck = str(tmp_path / "ck")
    svc = SchedulerService(spec, device="cpu", checkpoint_dir=ck,
                           checkpoint_every=3, crash_after=7)
    with pytest.raises(SimulatedCrash):
        svc.run()
    assert committed_steps(ck)[-1] == 6
    resumed = SchedulerService.resume(ck, device="cpu")
    assert resumed._next_event == 6 and resumed.device == "cpu"
    assert [e.to_dict() for e in resumed.trace] \
        == [e.to_dict() for e in svc.trace]
    resumed.run()
    assert committed_steps(ck)[-1] > 6


def test_checkpoints_are_gcd_to_keep_limit(tmp_path):
    _, spec = online("random")
    ck = str(tmp_path / "ck")
    svc = SchedulerService(spec, device="cpu", checkpoint_dir=ck,
                           checkpoint_every=1)
    svc.run()
    steps = committed_steps(ck)
    assert len(steps) <= svc._ckpt_manager.keep
    assert steps[-1] == svc._next_event


def test_crash_before_first_checkpoint_cannot_resume(tmp_path):
    _, spec = online("random")
    ck = str(tmp_path / "ck")
    svc = SchedulerService(spec, device="cpu", checkpoint_dir=ck,
                           checkpoint_every=50, crash_after=2)
    with pytest.raises(SimulatedCrash):
        svc.run()
    assert committed_steps(ck) == []
    with pytest.raises(FileNotFoundError):
        SchedulerService.resume(ck, device="cpu")


def test_service_metrics_state_round_trip():
    m = ServiceMetrics()
    m.arrivals, m.departures, m.rejections = 5, 3, 1
    ts = m.tenant("tenant-a", template=1)
    ts.rounds, ts.total_cost, ts.best_accuracy = 2, 3.5, 0.8
    ts.admissions, ts.queued_at = 1, 10.0
    m.decision_latency.add(0.01)
    m.sample_queue_depth(4)
    m2 = ServiceMetrics()
    m2.load_state(m.to_state())
    assert m2.to_state() == m.to_state()


# ---- the service itself ----------------------------------------------------

@pytest.mark.parametrize("preset", ["online-smoke", "slo-overload"])
def test_service_records_match_reference(preset):
    ref, port = (online("greedy") if preset == "online-smoke"
                 else overload("greedy"))
    a, b = run_ref(ref), run_port(port)
    assert_services_agree(a, b)
    ra, rb = a.last_report.to_dict(), b.last_report.to_dict()
    for r in (ra, rb):
        for key in ("decision_latency", "decisions_per_sec",
                    "rounds_per_sec", "wall_s"):
            r.pop(key)
        if r["resilience"] is not None:
            r["resilience"].pop("rung_latency_ms", None)
    assert ra == rb


def test_incremental_and_full_rescoring_execute_identically():
    _, spec = online("greedy", with_faults=False)
    inc = run_port(spec, rescore_mode="incremental")
    full = run_port(spec, rescore_mode="full")
    assert record_tuples(inc) == record_tuples(full)
    assert len(inc.rescore_costs) == len(full.rescore_costs) > 0


def test_service_requires_arrivals_axis():
    spec = presets.get_preset("quickstart", scheduler="greedy")
    with pytest.raises(ValueError, match="arrivals"):
        SchedulerService(spec, device="cpu")


LEARNERS = {
    "bods": {"num_candidates": 64, "init_points": 4},
    "rlds": {"pretrain_rounds": 0},
    "dnn": {"num_candidates": 64},
}


@pytest.mark.parametrize("name", sorted(LEARNERS))
def test_warm_handoff_identical_next_decision(name):
    """A retired job's per-job state transplanted under a NEW job id (the
    readmission path) gives the exact next decision the uninterrupted
    scheduler would have made."""
    from repro_torch.core.cost import CostModel
    from repro_torch.core.devices import DevicePool
    from repro_torch.core.schedulers import get_scheduler
    from repro_torch.core.schedulers.base import SchedulingContext

    pool = DevicePool.heterogeneous(24, 2, seed=5)
    cm = CostModel(pool, alpha=4.0, beta=0.25, device="cpu")
    cm.calibrate([5.0, 5.0], n_sel=4)
    sched = get_scheduler(name, cost_model=cm, seed=0, **LEARNERS[name])

    def ctx(job, r, counts):
        return SchedulingContext(
            job=job, round_idx=r, tau=5.0, n_sel=4,
            available=np.ones(24, dtype=bool), counts=counts.copy(),
            expected_times=pool.expected_times(job, 5.0))

    counts = np.zeros((2, 24))
    for r in range(3):
        for j in (0, 1):
            c = ctx(j, r, counts[j])
            plan = sched.schedule(c)
            sched.observe(c, plan, float(sched.last_estimated_cost or 1.0))
            counts[j] += plan
    snap = sched.snapshot()
    plan_uninterrupted = sched.schedule(ctx(1, 3, counts[1]))
    sched.restore(snap)
    saved = sched.job_state_dict(1)
    pool.add_job(pool.data_sizes[:, 1].copy())
    sched.ensure_jobs(3)
    sched.load_job_state(2, saved)
    np.testing.assert_array_equal(plan_uninterrupted,
                                  sched.schedule(ctx(2, 3, counts[1])))


def test_readmission_carries_bods_state():
    _, spec = online("bods", with_faults=False)
    svc = run_port(spec)
    assert svc.metrics.readmissions > 0


@pytest.mark.parametrize("slo,clamps", [
    ({"max_launch_retries": 1, "retry_base_delay": 5.0}, True),
    ({"max_launch_retries": 0}, True),
    ({"max_launch_retries": 2, "retry_backoff": 3.0,
      "retry_base_delay": 1.0}, False),
], ids=["clamp-after-1", "clamp-at-once", "backoff-3"])
def test_bounded_launch_retries_match_reference(slo, clamps):
    """The engine's bounded relaunch (retries, backoff, the clamped cohort)
    through the spec's ``slo`` axis, as the reference's."""
    ref, port = twin("quickstart", scheduler="greedy", n_jobs=2,
                     num_devices=10, max_rounds=4, target=2.0)
    ref, port = (s.replace(n_sel=6, slo=slo) for s in (ref, port))
    a = ref.run().records
    b = port.run(device="cpu").records
    clamped = [r for r in b if len(r.device_ids) + len(r.dropped) < 6]
    assert bool(clamped) == clamps
    assert record_rows(a) == record_rows(b)


def test_bounded_agg_retries_match_reference():
    """An injected aggregation failure is retried ``max_agg_retries`` times
    and then recorded degraded with carried-forward metrics, in both."""
    def flaky(runtime, calls):
        orig = runtime.run_round

        def run_round(job_id, device_ids, round_idx):
            calls.append(job_id)
            if job_id == 1 and round_idx == 1:
                raise RuntimeError("injected aggregation failure")
            return orig(job_id, device_ids, round_idx)

        runtime.run_round = run_round

    ref, port = twin("quickstart", scheduler="greedy", n_jobs=2,
                     num_devices=30, max_rounds=3, target=2.0)
    out = []
    for spec, kw in ((ref, {}), (port, {"device": "cpu"})):
        ex = spec.replace(slo={"max_agg_retries": 1}).build(**kw)
        calls = []
        flaky(ex.engine.runtime, calls)
        out.append((ex.run().records, calls))
    (a, ca), (b, cb) = out
    assert record_rows(a) == record_rows(b)
    assert ca == cb and len(cb) == len(b) + 1
    bad = [r for r in b if r.job == 1 and r.round_idx == 1]
    assert len(bad) == 1 and bad[0].degraded


def test_agg_failure_without_retry_budget_still_raises():
    spec = presets.get_preset("quickstart", scheduler="greedy", n_jobs=2,
                              num_devices=30, max_rounds=2)
    ex = spec.build(device="cpu")

    def broken(job_id, device_ids, round_idx):
        raise RuntimeError("boom")

    ex.engine.runtime.run_round = broken
    with pytest.raises(RuntimeError, match="boom"):
        ex.run()


# ---- the CLI ---------------------------------------------------------------

def test_cli_smoke(tmp_path, capsys):
    from repro_torch.serve.__main__ import main

    out = tmp_path / "report.json"
    trace = tmp_path / "trace.json"
    records = tmp_path / "records.json"
    main(["--preset", "online-smoke", "--arg", "horizon=3000",
          "--arg", "num_devices=30", "--arg", "scheduler=greedy",
          "--device", "cpu", "--save-trace", str(trace), "--out", str(out),
          "--records-out", str(records)])
    rep = json.loads(out.read_text())
    assert rep["rounds_completed"] == len(json.loads(records.read_text())) > 0
    assert len(traffic.load_trace(str(trace))) > 0
    assert "latency" in capsys.readouterr().out


def serve_cli(args, cwd):
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.serve", "--device", "cpu", *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_cli_kill9_and_resume(tmp_path):
    """``--crash-after`` exits 137 without cleanup; ``--resume`` of its
    directory gives the uninterrupted run's records (as the reference's
    ``benchmarks/chaos_smoke.py --overload``)."""
    _, spec = overload()
    spec.save(str(tmp_path / "spec.json"))
    ref = serve_cli(["--spec", "spec.json", "--records-out", "ref.json"],
                    tmp_path)
    assert ref.returncode == 0, ref.stderr
    crash = serve_cli(["--spec", "spec.json", "--checkpoint-dir", "ck",
                       "--checkpoint-every", "3", "--crash-after", "7"],
                      tmp_path)
    assert crash.returncode == 137, crash.stderr
    res = serve_cli(["--resume", "ck", "--records-out", "res.json"],
                    tmp_path)
    assert res.returncode == 0, res.stderr
    a = json.loads((tmp_path / "ref.json").read_text())
    b = json.loads((tmp_path / "res.json").read_text())
    assert a == b and len(a) > 0
    assert any(r["rung"] != "full" for r in a)
