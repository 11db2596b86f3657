"""The port's scheduling loop vs the reference, end to end.

The same presets, seeds and (numpy-driven) schedulers must give identical
``RoundRecord`` streams and summaries; a run carried across from the
reference in the middle (``repro_torch.convert``) must finish identically;
the reference's spec and result JSON must replay unchanged; the port must
import neither ``jax`` nor ``repro``.
"""

import copy
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.experiment import presets as ref_presets  # noqa: E402
from repro.experiment.spec import ExperimentResult as RefResult  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.experiment import presets  # noqa: E402
from repro_torch.experiment.spec import ExperimentSpec, JobSpec  # noqa: E402

SCHEDULERS = ("random", "greedy", "fedcs", "genetic", "sa")
PRESETS = ("quickstart", "paper-group-a", "paper-group-b", "fault-injection")
SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs several test files at once, and
    the timing-sensitive tests of other files must not be starved."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def shorten(spec, max_rounds):
    return spec.replace(jobs=tuple(dataclasses.replace(j, max_rounds=max_rounds)
                                   for j in spec.jobs))


def twin_specs(preset, scheduler, max_rounds=12, backend="numpy", **kw):
    """The same preset from both packages, host search, fixed backend."""
    out = []
    for mod in (ref_presets, presets):
        spec = mod.get_preset(preset, scheduler=scheduler, **kw)
        spec = shorten(spec, max_rounds).replace(scoring_backend=backend,
                                                 search_backend="host")
        if scheduler == "sa":
            spec = spec.replace(scheduler_kwargs={"steps": 40})
        out.append(spec)
    return out


def record_dict(r):
    d = dataclasses.asdict(r)
    for key in ("device_ids", "dropped", "corrupt_ids", "failed_ids"):
        d[key] = np.asarray(d[key]).astype(int).tolist()
    return d


def assert_records_identical(ref_records, port_records):
    assert len(ref_records) == len(port_records) > 0
    for a, b in zip(ref_records, port_records):
        assert record_dict(a) == record_dict(b)


@pytest.mark.parametrize("scheduler", SCHEDULERS)
@pytest.mark.parametrize("preset", PRESETS)
def test_preset_records_identical(preset, scheduler):
    ref_spec, port_spec = twin_specs(preset, scheduler)
    assert port_spec.to_dict() == ref_spec.to_dict()
    a = ref_spec.run()
    b = port_spec.run(device="cpu")
    assert_records_identical(a.records, b.records)
    assert a.summary == b.summary


@pytest.mark.parametrize("scheduler", ["random", "greedy"])
def test_vectorized_runtime_branch_identical(scheduler):
    """K > 4096 takes SyntheticRuntime's vectorized class sampling."""
    ref_spec, port_spec = twin_specs("quickstart", scheduler, max_rounds=3,
                                     num_devices=5000, n_jobs=2)
    a = ref_spec.run()
    b = port_spec.run(device="cpu")
    assert_records_identical(a.records, b.records)
    assert a.summary == b.summary


def test_device_backends_through_the_engine():
    """torch/cuda scoring on the CPU: greedy's decisions are closed-form,
    so the records match the reference's jax run with est_cost within the
    scoring tolerance; genetic's decisions are the same on torch and cuda."""
    ref_spec, port_spec = twin_specs("paper-group-a", "greedy", max_rounds=6,
                                     backend="jax")
    a = ref_spec.run().records
    for backend in ("torch", "cuda"):
        b = port_spec.replace(scoring_backend=backend).run(device="cpu")
        assert len(a) == len(b.records)
        for ra, rb in zip(a, b.records):
            da, db = record_dict(ra), record_dict(rb)
            assert abs(da.pop("est_cost") - db.pop("est_cost")) <= 1e-5
            assert da == db
    _, port_spec = twin_specs("quickstart", "genetic", max_rounds=5,
                              backend="torch", num_devices=400)
    runs = [port_spec.replace(scoring_backend=b).run(device="cpu").records
            for b in ("torch", "cuda")]
    for ra, rb in zip(*runs):
        da, db = record_dict(ra), record_dict(rb)
        assert abs(da.pop("est_cost") - db.pop("est_cost")) <= 1e-5
        assert da == db


@pytest.mark.parametrize("preset,scheduler", [
    ("fault-injection", "genetic"), ("paper-group-b", "sa"),
    ("quickstart", "fedcs")])
def test_state_carried_across_mid_run(preset, scheduler):
    """Advance the reference to t, carry its numpy/JSON state over, finish
    both: the port's records continue the reference's exactly."""
    ref_spec, _ = twin_specs(preset, scheduler)
    full = ref_spec.run().records
    exp = ref_spec.build()
    eng = exp.engine
    for m in range(len(eng.jobs)):
        eng.launch_job(m, 0.0)
    t_mid = full[len(full) // 2].t_end
    eng.advance_until(t_mid)
    done = len(eng.records)
    state = copy.deepcopy({
        "pool": eng.pool.state_dict(),
        "pool_rng": eng.pool.rng.bit_generator.state,
        "engine_arrays": eng.state_arrays(),
        "engine_meta": json.loads(json.dumps(eng.state_meta())),
        "runtime": eng.runtime.state_dict(),
        "runtime_rng": eng.runtime.rng.bit_generator.state,
        "scheduler": eng.scheduler.snapshot(),
    })
    port = convert.load_engine_state(ref_spec.to_dict(), state, device="cpu")
    port.engine.run()
    eng.run()
    assert_records_identical(full[done:], port.engine.records)
    assert_records_identical(eng.records[done:], port.engine.records)


def test_reference_result_json_replays(tmp_path):
    """A result saved by the reference (with its jax backend name) loads as
    a port spec and replays to the same records."""
    ref_spec = ref_presets.get_preset("fleet-scale", scheduler="greedy",
                                      num_devices=300, max_rounds=3)
    assert ref_spec.fleet.scoring_backend == "jax"
    path = tmp_path / "result.json"
    ref_spec.replace(scoring_backend="pallas").run().save(str(path))
    with open(path) as f:
        d = json.load(f)
    spec = ExperimentSpec.from_dict(d["spec"])
    assert spec.fleet.scoring_backend == "torch"
    assert spec.scoring_backend == "cuda"
    replay = spec.replace(scoring_backend="numpy").run(device="cpu")
    ref_replay = RefResult.load(str(path)).spec.replace(
        scoring_backend="numpy").run()
    assert_records_identical(ref_replay.records, replay.records)


@pytest.mark.parametrize("change,module", [
    (dict(slo={"max_launch_retries": 2}), "module 8"),
    (dict(obs={"trace_path": "t.json"}), "module 8"),
    (dict(policy="rlds-default"), "module 9"),
    (dict(fleet={"num_shards": 2}), "module 7"),
    (dict(scheduler="bods"), "module 5"),
    (dict(scheduler="genetic", search_backend="fused"), "module 5"),
    (dict(runtime="real_fl", jobs=(JobSpec(name="lm", model="qwen3-8b"),)),
     "module 10"),
])
def test_axes_not_ported_raise(change, module):
    spec = presets.get_preset("quickstart", scheduler="greedy").replace(
        **change)
    with pytest.raises(NotImplementedError, match=module):
        spec.build(device="cpu")


def test_model_other_than_stub_raises():
    """Only the language-model arch ids still raise (ROADMAP module 10); the
    paper's CNN zoo builds and trains (tests/test_torch_runtime.py)."""
    spec = presets.get_preset("real-fl-two-job", scheduler="greedy")
    exp = spec.build(device="cpu")
    names = [j.config.model.name for j in exp.engine.jobs]
    assert names == ["paper-lenet5", "paper-cnn-b"]
    lm = spec.replace(jobs=(JobSpec(name="lm", model="qwen3-8b"),))
    with pytest.raises(NotImplementedError, match="module 10"):
        lm.build(device="cpu")


def test_port_imports_neither_jax_nor_reference():
    code = (
        "import sys\n"
        "from repro_torch.experiment.presets import get_preset\n"
        "import repro_torch.convert, repro_torch.experiment.cli\n"
        "import repro_torch.kernels.ops, repro_torch.kernels.build\n"
        "import repro_torch.fl, repro_torch.models.cnn_zoo\n"
        "import repro_torch.optim.compression, repro_torch.configs\n"
        "r2 = get_preset('real-fl-two-job', scheduler='greedy', rounds=1,"
        " num_devices=10).replace(runtime_kwargs={'samples_per_job': 400,"
        " 'eval_samples': 40}).run(device='cpu')\n"
        "assert len(r2.records) == 2, len(r2.records)\n"
        "r = get_preset('quickstart', scheduler='genetic', max_rounds=2)"
        ".replace(search_backend='host', scoring_backend='cuda')"
        ".run(device='cpu')\n"
        "assert len(r.records) == 6, len(r.records)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_cli_runs_preset_on_cpu(tmp_path, capsys):
    from repro_torch.experiment import cli

    out = tmp_path / "r.json"
    cli.main(["preset", "quickstart", "--arg", "scheduler=greedy",
              "--arg", "max_rounds=2", "--device", "cpu", "--out",
              str(tmp_path / "s.json"), "--run"])
    cli.main(["run", str(tmp_path / "s.json"), "--device", "cpu",
              "--out", str(out)])
    text = capsys.readouterr().out
    assert "quickstart-greedy" in text
    with open(out) as f:
        assert len(json.load(f)["records"]) == 6


def test_tracer_and_event_bus_observe_without_changing_records():
    """The engine's spans and bus topics fire; records stay identical to an
    unobserved run."""
    from repro_torch.monitoring import trace
    from repro_torch.monitoring.bus import EventBus

    spec = presets.get_preset("quickstart", scheduler="fedcs", max_rounds=3)
    plain = spec.run(device="cpu").records
    exp = spec.build(device="cpu")
    bus = EventBus()
    seen = {"round": 0, "round_begin": 0, "job_done": 0}
    for topic in seen:
        bus.subscribe(topic, lambda _p, t=topic: seen.__setitem__(t, seen[t] + 1))
    exp.engine.events = bus
    trace.get_tracer().clear()
    trace.enable()
    try:
        observed = exp.run().records
    finally:
        trace.disable()
    names = {e["name"] for e in trace.get_tracer().events()}
    trace.get_tracer().clear()
    assert {"engine_run", "ctx_build", "schedule", "dispatch", "aggregate",
            "record"} <= names
    assert seen == {"round": 9, "round_begin": 9, "job_done": 3}
    assert_records_identical(plain, observed)
