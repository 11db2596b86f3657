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
    ("quickstart", "fedcs"), ("paper-group-a", "bods")])
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


# Each case keeps the id it had when the list also held module 7's,
# module 8's and module 9's axes. Neither raises for a missing module any
# more: the reference's real_fl trains only the CNN zoo, and musicgen-medium
# resolves since module 10.c.
@pytest.mark.parametrize("change,module", [
    pytest.param(dict(runtime="real_fl", runtime_kwargs={},
                      jobs=(JobSpec(name="lm", model="musicgen-medium"),)),
                 "trains only the paper's CNN zoo", id="change4-module 10"),
    # the reference's real_fl trains only the CNN zoo, so no module fills
    # this; the id is the one the case had when the guard named module 10
    pytest.param(dict(runtime="real_fl", runtime_kwargs={},
                      jobs=(JobSpec(name="lm", model="qwen3-8b"),)),
                 "trains only the paper's CNN zoo", id="change7-module 10"),
])
def test_axes_not_ported_raise(change, module):
    spec = presets.get_preset("quickstart", scheduler="greedy").replace(
        **change)
    with pytest.raises(NotImplementedError, match=module):
        spec.build(device="cpu")


@pytest.mark.parametrize("num_shards", [2, "auto"])
@pytest.mark.parametrize("scheduler,search", [
    ("genetic", "host"), ("sa", "fused"), ("bods", "fused")])
def test_module7_fleet_shards_build_and_run(num_shards, scheduler, search):
    """What raised until module 7 was ported (``fleet.num_shards`` > 1) now
    builds and runs: the cost model carries the resolved shard count (1
    for "auto" without a card), and the records hold n_sel distinct
    devices. tests/test_torch_shard.py holds them to the reference's."""
    spec = presets.get_preset("quickstart", scheduler=scheduler,
                              max_rounds=2).replace(
        fleet={"num_shards": num_shards, "scoring_backend": "torch"},
        search_backend=search)
    exp = spec.build(device="cpu")
    want = 2 if num_shards == 2 else max(torch.cuda.device_count(), 1)
    assert exp.engine.cost_model.num_shards == want
    records = exp.run().records
    assert len(records) == 2 * len(spec.jobs)
    for r in records:
        assert np.unique(r.device_ids).size == spec.effective_n_sel()


@pytest.mark.parametrize("change", [
    dict(slo={"max_launch_retries": 2, "max_queue_depth": 4}),
    dict(obs={"trace_path": "t.json", "metrics_path": "m.jsonl",
              "audit_path": "a.jsonl"}),
], ids=["slo", "obs"])
def test_module8_axes_build_and_run(change, tmp_path, monkeypatch):
    """What raised until module 8 was ported (a non-inert ``slo``, an
    active ``obs``) now builds and runs: the SLO axis hangs the decision
    governor on the engine and sets its retry knobs; the obs axis writes
    the trace, one metrics row and one audit row per record."""
    monkeypatch.chdir(tmp_path)
    spec = presets.get_preset("quickstart", scheduler="greedy",
                              max_rounds=2).replace(**change)
    exp = spec.build(device="cpu")
    records = exp.run().records
    assert len(records) == 2 * len(spec.jobs)
    if "slo" in change:
        assert exp.engine.governor is not None
        assert exp.engine.max_launch_retries == 2
        assert {r.rung for r in records} <= {"full", "incremental",
                                              "greedy", "last_good"}
    else:
        assert exp.engine.obs is not None
        for name in ("m.jsonl", "a.jsonl"):
            assert len((tmp_path / name).read_text().splitlines()) \
                == len(records)
        assert "traceEvents" in json.loads((tmp_path / "t.json").read_text())


@pytest.mark.parametrize("scheduler", ["rlds", "dnn", "bods"])
def test_module9_policy_axis_builds_and_runs(scheduler, tmp_path):
    """What raised until module 9 was ported (the ``policy`` axis) now
    builds and runs: the spec warm-starts its scheduler from the zoo entry
    (an RLDS entry skips the lazy pretraining). tests/test_torch_zoo.py
    holds the records to the reference's."""
    from repro_torch.gym import PolicyZoo

    spec = presets.get_preset("quickstart", scheduler=scheduler,
                              max_rounds=2)
    donor = spec.build(device="cpu").engine.scheduler
    PolicyZoo(str(tmp_path)).save_scheduler("p", donor)
    spec = spec.replace(policy="p", policy_dir=str(tmp_path))
    exp = spec.build(device="cpu")
    assert exp.engine.scheduler.name == scheduler
    if scheduler == "rlds":
        assert exp.engine.scheduler._pretrain_cfg[0] == 0
    records = exp.run().records
    assert len(records) == 2 * len(spec.jobs)


@pytest.mark.parametrize("change", [
    dict(scheduler="bods"),
    dict(scheduler="genetic", search_backend="fused"),
], ids=["bods", "genetic-fused"])
def test_module5_axes_build_and_run_a_round(change):
    """What raised until module 5 was ported (the paper's default
    scheduler, the fused search) now builds and runs one round."""
    spec = presets.get_preset("quickstart", scheduler="greedy",
                              max_rounds=1).replace(**change)
    exp = spec.build(device="cpu")
    assert exp.engine.scheduler.search_backend == "fused"
    records = exp.run().records
    assert len(records) == len(spec.jobs)
    for r in records:
        assert np.unique(r.device_ids).size == spec.effective_n_sel()


def test_model_other_than_stub_raises():
    """The paper's CNN zoo builds and trains under real_fl
    (tests/test_torch_runtime.py); an audio or VLM language model resolves
    but real_fl refuses it, as the reference's trains only the CNN zoo."""
    spec = presets.get_preset("real-fl-two-job", scheduler="greedy")
    exp = spec.build(device="cpu")
    names = [j.config.model.name for j in exp.engine.jobs]
    assert names == ["paper-lenet5", "paper-cnn-b"]
    for model in ("musicgen-medium", "paligemma-3b"):
        lm = spec.replace(jobs=(JobSpec(name="lm", model=model),))
        with pytest.raises(NotImplementedError,
                           match="trains only the paper's CNN zoo"):
            lm.build(device="cpu")


@pytest.mark.parametrize("model", ["qwen3-8b", "deepseek-67b", "dbrx-132b",
                                   "hymba-1.5b", "xlstm-350m",
                                   "musicgen-medium", "paligemma-3b"])
def test_synthetic_preset_with_dense_llm_job_identical(model):
    """A dense, MoE, hybrid, SSM, audio or VLM LLM id resolves in both
    packages: a synthetic-runtime run with such a job gives the reference's
    records."""
    ref_spec, port_spec = twin_specs("quickstart", "greedy", max_rounds=6)
    jobs = (JobSpec(name="lm", model=model, max_rounds=6),) + tuple(
        port_spec.jobs[1:])
    port_spec = port_spec.replace(jobs=jobs)
    ref_spec = ref_spec.from_dict(port_spec.to_dict())
    assert ref_spec.to_dict() == port_spec.to_dict()
    a = ref_spec.run()
    b = port_spec.run(device="cpu")
    assert_records_identical(a.records, b.records)
    assert a.summary == b.summary


def test_port_imports_neither_jax_nor_reference():
    code = (
        "import sys\n"
        "from repro_torch.experiment.presets import get_preset\n"
        "import repro_torch.convert, repro_torch.experiment.cli\n"
        "import repro_torch.kernels.ops, repro_torch.kernels.build\n"
        "import repro_torch.fl, repro_torch.models.cnn_zoo\n"
        "import repro_torch.optim.compression, repro_torch.configs\n"
        "import repro_torch.launch.serve, repro_torch.launch.steps\n"
        "import repro_torch.kernels.flash_attention\n"
        "import repro_torch.kernels.decode_attention\n"
        "import repro_torch.kernels.moe_gmm, repro_torch.kernels.ssm_scan\n"
        "import repro_torch.kernels.rmsnorm\n"
        "import repro_torch.models.moe, repro_torch.models.ssm\n"
        "import repro_torch.config.shapes\n"
        "from repro_torch.launch.serve import load_config, serve\n"
        "from repro_torch.models.transformer import lm_init\n"
        "cfg = load_config('qwen3-1.7b', reduced=True)\n"
        "res = serve(cfg, lm_init(cfg, device='cpu'), requests=3, slots=2,"
        " max_new=3, cache_len=8, device='cpu')\n"
        "assert res.steps == 6, res.steps\n"
        "for a in ('dbrx-132b', 'hymba-1.5b', 'xlstm-350m'):\n"
        "    c = load_config(a, reduced=True)\n"
        "    serve(c, lm_init(c, device='cpu'), requests=2, slots=2,"
        " max_new=2, cache_len=8, device='cpu')\n"
        "r2 = get_preset('real-fl-two-job', scheduler='greedy', rounds=1,"
        " num_devices=10).replace(runtime_kwargs={'samples_per_job': 400,"
        " 'eval_samples': 40}).run(device='cpu')\n"
        "assert len(r2.records) == 2, len(r2.records)\n"
        "r = get_preset('quickstart', scheduler='genetic', max_rounds=2)"
        ".replace(search_backend='host', scoring_backend='cuda')"
        ".run(device='cpu')\n"
        "assert len(r.records) == 6, len(r.records)\n"
        "import repro_torch.core.search, repro_torch.optim.optimizers\n"
        "import repro_torch.gym, repro_torch.gym.cli\n"
        "import repro_torch.core.loss_estimation\n"
        "import repro_torch.core.shard, repro_torch.launch.bootstrap\n"
        "r = get_preset('quickstart', scheduler='genetic', max_rounds=2)"
        ".replace(search_backend='host', scoring_backend='cuda',"
        " fleet={'num_shards': 2}).run(device='cpu')\n"
        "assert len(r.records) == 6, len(r.records)\n"
        "from repro_torch.gym import TrainConfig, default_stages, train_rlds\n"
        "train_rlds(default_stages(num_devices=(24,)), TrainConfig("
        "num_envs=2, rollout_len=2, iters=1), device='cpu')\n"
        "for s, kw in (('bods', {}), ('rlds', {'pretrain_rounds': 2})):\n"
        "    r = get_preset('quickstart', scheduler=s, max_rounds=2)"
        ".replace(scheduler_kwargs=kw).run(device='cpu')\n"
        "    assert len(r.records) == 6, (s, len(r.records))\n"
        "import tempfile\n"
        "import repro_torch.checkpoint, repro_torch.monitoring\n"
        "import repro_torch.serve, repro_torch.monitoring.report\n"
        "from repro_torch.serve.service import SchedulerService\n"
        "tmp = tempfile.TemporaryDirectory()\n"
        "spec = get_preset('slo-overload', scheduler='bods',"
        " num_devices=30, horizon=3000.0)\n"
        "svc = SchedulerService(spec, device='cpu', checkpoint_dir=tmp.name,"
        " checkpoint_every=2)\n"
        "svc.run()\n"
        "SchedulerService.resume(tmp.name, device='cpu')\n"
        "tmp.cleanup()\n"
        "assert len(svc.engine.records) > 0\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')"
        " or m == 'ml_dtypes' or m.startswith('ml_dtypes.')]\n"
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
