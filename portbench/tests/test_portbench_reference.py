"""The reference against the port on a cell cut to the CPU's size, the
control that must come out not correct, and a run with the timed path
broken underneath for each fault the cells can have."""

import time

import numpy as np
import pytest
import torch

from portbench import check, harness
from portbench.reference import cnn


def _run(cell, seed=2 ** 31 + 7):
    # 3 s: every job trains a round in the window at this size.
    return harness.run(cell, seed, 3.0, False, time.time(), device="cpu")


def test_the_port_agrees_with_the_reference(tiny_cell):
    out = _run(tiny_cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    rate = out["metrics"]["train_samples_per_s"]
    assert rate["value"] > 0 and rate["unit"] == "samples/s"
    assert list(out)[-1] == "checks"
    for name, c in out["checks"].items():
        assert np.isfinite(c["value"]) and c["value"] <= c["limit"], name


def test_the_traced_run_reads_the_spans(tiny_cell):
    out = harness.run(tiny_cell, 12, 3.0, True, time.time(), device="cpu")
    assert out["correct"]
    names = set(out["metrics"])
    assert {"engine_host_ms_per_round", "decide_ms"} <= names
    # Nothing ran on a card: no device metric is reported.
    assert not names & {"device_idle_pct", "sgd_mfu", "peak_mem_gib",
                        "launches_per_sgd_step"}


def test_the_control_is_not_correct(tiny_cell):
    """The reference in TF32 (the next precision below the configuration's
    float32), put in the program's place, fails a limit."""
    cell = tiny_cell
    prep = harness.prepare(cell, 5, "cpu")
    harness.warm_up(prep, cell.traffic["check_rounds"])
    launches = list(prep.probe.launches)
    records = harness.records_by_round(prep.engine.records)
    judged = harness.judge_training(
        cell, prep.seeds, launches, records, prep.probe.snapshots, "cpu",
        {"tf32": ("tf32", cnn.fedavg)})
    training = {k: v for k, v in cell.limits.items() if k in judged["tf32"]}
    assert check.verdict(judged["program"], training)
    assert not check.verdict(judged["tf32"], training), judged["tf32"]


def _unchanged(params, ids, *args, **kwargs):
    return params, torch.zeros(())


def _half_fedavg(stacked, weights):
    from repro_torch.fl import aggregation

    n = max(1, weights.shape[0] // 2)
    head = lambda t: {k: head(v) for k, v in t.items()} \
        if isinstance(t, dict) else t[:n]
    return aggregation.fedavg([head(layer) for layer in stacked], weights[:n])


def _altered_plan(schedule):
    def wrapped(self, ctx):
        plan = schedule(self, ctx).copy()
        chosen = np.flatnonzero(plan)
        free = np.flatnonzero(ctx.available & ~plan)
        plan[chosen[0]], plan[free[0]] = False, True
        return plan
    return wrapped


def _first_free(self, ctx):
    from portbench import control

    return control.first_free(ctx)


def _unchanged_once_warm(monkeypatch):
    """``_train_round`` returns its state unchanged from the window on."""
    from repro_torch.fl import runtime

    warm = [False]
    train = runtime._train_round

    def train_round(params, *args, **kwargs):
        if warm[0]:
            return params, torch.zeros(())
        return train(params, *args, **kwargs)

    def warm_up(prep, rounds):
        warm_up.original(prep, rounds)
        warm[0] = True

    warm_up.original = harness.warm_up
    monkeypatch.setattr(runtime, "_train_round", train_round)
    monkeypatch.setattr(harness, "warm_up", warm_up)


def _altered_loss(fn):
    return lambda *a: (lambda la: (la[0] * 1.001, la[1]))(fn(*a))


@pytest.mark.parametrize("fault", ["state_unchanged", "half_cohort",
                                   "cohort_altered", "loss_altered",
                                   "plan_first_free",
                                   "unchanged_once_warm"])
def test_a_broken_timed_path_is_not_correct(tiny_cell, monkeypatch, fault):
    from repro_torch.core.schedulers.bods import BODSScheduler
    from repro_torch.fl import runtime

    if fault == "state_unchanged":
        monkeypatch.setattr(runtime, "_train_round", _unchanged)
    elif fault == "half_cohort":
        monkeypatch.setattr(runtime, "fedavg", _half_fedavg)
    elif fault == "cohort_altered":
        monkeypatch.setattr(BODSScheduler, "schedule",
                            _altered_plan(BODSScheduler.schedule))
    elif fault == "plan_first_free":
        monkeypatch.setattr(BODSScheduler, "schedule", _first_free)
    elif fault == "unchanged_once_warm":
        _unchanged_once_warm(monkeypatch)
    else:
        monkeypatch.setattr(runtime, "cnn_loss_and_accuracy",
                            _altered_loss(runtime.cnn_loss_and_accuracy))
    out = _run(tiny_cell)
    assert not out["correct"], out["checks"]
    if fault == "plan_first_free":
        # The plans are valid: only the comparison with BODS catches them.
        assert out["checks"]["cohort_faults"]["value"] == 0
        assert (out["checks"]["bods_regret"]["value"]
                > out["checks"]["bods_regret"]["limit"])
    if fault == "unchanged_once_warm":
        # The warm-up trains soundly: only the window's round catches it.
        for name in ("loss_gap", "update_gap"):
            assert out["checks"][name]["value"] == 0, name


def test_the_readings_script_separates_program_control_and_faults(
        tiny_cell, monkeypatch, tmp_path, capsys):
    """``control.py`` at the CPU's size: the program reads inside every
    limit, and the control and each planted fault read outside one."""
    import json

    from portbench import control, manifest

    monkeypatch.setattr(manifest, "load_cell", lambda name: tiny_cell)
    out = tmp_path / "readings.jsonl"
    control.main(["--workload", tiny_cell.name, "--seeds", "9",
                  "--control-seeds", "9", "--device", "cpu",
                  "--out", str(out)])
    line = json.loads(out.read_text())
    limits = tiny_cell.limits
    assert check.verdict(line["program"], limits)
    for side in ("tf32", "half_cohort", "altered_cohort",
                 "expected_round_time", "absolute_fairness", "first_free"):
        read = {k: v for k, v in line[side].items() if k in limits}
        assert not check.verdict(read, {k: limits[k] for k in read}), side
