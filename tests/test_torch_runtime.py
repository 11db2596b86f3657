"""The port's training runtimes against the reference's on the CPU.

``FusedMultiRuntime`` and ``FLJobRuntime`` on the tiny config of
``tests/test_train_runtime.py`` (one and two jobs, ``eval_every``, robust
mode with injected corruption), the ``real_fl`` experiment through both
``ExperimentSpec``s, and a reference run carried across after round 1.

Tolerances, each with its reason: both packages train in float32 with the
same math but sum their matmuls in another order, and SGD carries those
last-bit differences forward. Params within 1e-5 of the largest parameter
after one round; losses within 1e-4 relative over several rounds; accuracy
within one eval sample (a logit near a tie may flip one argmax).
"""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.config.base import JobConfig as RefJobConfig  # noqa: E402
from repro.configs.paper_models import lenet5 as ref_lenet5  # noqa: E402
from repro.data.synthetic import make_classification_dataset  # noqa: E402
from repro.experiment import presets as ref_presets  # noqa: E402
from repro.faults import FaultEngine as RefFaultEngine  # noqa: E402
from repro.faults import FaultSpec as RefFaultSpec  # noqa: E402
from repro.fl import runtime as ref_rt  # noqa: E402
from repro.fl.partition import noniid_partition  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.config.base import JobConfig  # noqa: E402
from repro_torch.configs.paper_models import lenet5  # noqa: E402
from repro_torch.experiment import presets  # noqa: E402
from repro_torch.faults import FaultEngine, FaultSpec  # noqa: E402
from repro_torch.fl import runtime as rt  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

NUM_DEV = 20
EVAL = 120
TINY = dict(name="tiny", input_shape=(8, 8, 1),
            cnn_spec=(("convp", 4, 3), ("flatten",), ("fc", 16)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs several test files at once, and
    the timing-sensitive tests of other files must not be starved."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def setup(num_jobs=1, seed=0, eval_samples=EVAL):
    """The reference's tiny-config jobs, the port's twins, and their shared
    numpy datasets."""
    ref_cfg = dataclasses.replace(ref_lenet5(), **TINY)
    cfg = dataclasses.replace(lenet5(), **TINY)
    ref_jobs, jobs, datasets = [], [], []
    for j in range(num_jobs):
        x, y = make_classification_dataset(600, cfg.input_shape,
                                           cfg.num_classes, noise=1.0,
                                           seed=seed + j)
        ex, ey = make_classification_dataset(eval_samples, cfg.input_shape,
                                             cfg.num_classes, noise=1.0,
                                             seed=seed + 50 + j)
        part = noniid_partition(y, NUM_DEV, seed=seed + j)
        kw = dict(job_id=j, target_metric=2.0, local_epochs=2, batch_size=4,
                  lr=0.05)
        ref_jobs.append(RefJobConfig(model=ref_cfg, **kw))
        jobs.append(JobConfig(model=cfg, **kw))
        datasets.append((x, y, part, ex, ey))
    return ref_jobs, jobs, datasets


def param_err(ref_params, params) -> float:
    """max |ref - port| over leaves, relative to the largest parameter."""
    ref = [np.asarray(a) for a in jax.tree_util.tree_leaves(ref_params)]
    port = [b.numpy() for b in tree_leaves(params)]
    assert len(ref) == len(port)
    scale = max(float(np.abs(a).max()) for a in ref)
    return max(float(np.abs(a - b).max()) for a, b in zip(ref, port)) / scale


def assert_metrics_close(a, b, eval_samples=EVAL):
    assert set(a) == set(b)
    assert abs(a["accuracy"] - b["accuracy"]) <= 1.0 / eval_samples + 1e-6
    assert abs(a["loss"] - b["loss"]) <= 1e-4 * max(1.0, abs(a["loss"]))
    if "rejected" in a:
        assert a["rejected"] == b["rejected"]


def test_bucket_helpers_match_reference():
    for K in (1, 5, 40, 64, 100):
        assert rt.default_buckets(K) == ref_rt.default_buckets(K)
    for n in (1, 4, 9, 16):
        assert rt.bucket_for(n, (4, 8, 16)) == ref_rt.bucket_for(n, (4, 8, 16))
    with pytest.raises(ValueError):
        rt.bucket_for(17, (4, 8, 16))


@pytest.mark.parametrize("fused", [True, False])
def test_single_job_matches_reference(fused):
    """Varying cohort sizes: params after round 1, metrics every round."""
    ref_jobs, jobs, datasets = setup()
    if fused:
        ref = ref_rt.FusedMultiRuntime(ref_jobs, datasets, seed=0)
        port = rt.FusedMultiRuntime(jobs, datasets, seed=0, device="cpu")
        ref_params, params = ref.params_of, port.params_of
    else:
        ref = ref_rt.FLJobRuntime(ref_jobs[0], *datasets[0], seed=0)
        port = rt.FLJobRuntime(jobs[0], *datasets[0], seed=0, device="cpu")
        ref_params, params = (lambda j: ref.params), (lambda j: port.params)
    rng = np.random.default_rng(1)
    for r in range(4):
        ids = rng.choice(NUM_DEV, int(rng.integers(2, 10)), replace=False)
        assert_metrics_close(ref.run_round(0, ids, r),
                             port.run_round(0, ids, r))
        if r == 0:
            assert param_err(ref_params(0), params(0)) <= 1e-5


def test_cross_job_lane_matches_reference():
    """Two jobs sharing a config form one group; both in-flight rounds are
    announced before any demand and flushed together."""
    ref_jobs, jobs, datasets = setup(num_jobs=2)
    ref = ref_rt.FusedMultiRuntime(ref_jobs, datasets, seed=0)
    port = rt.FusedMultiRuntime(jobs, datasets, seed=0, device="cpu")
    assert len(port.groups) == 1 and port.groups[0].job_ids == [0, 1]
    rng = np.random.default_rng(2)
    for r in range(4):
        cohorts = [rng.choice(NUM_DEV, int(rng.integers(3, 7)), replace=False)
                   for _ in jobs]
        for j, ids in enumerate(cohorts):
            ref.begin_round(j, ids, r)
            port.begin_round(j, ids, r)
        for j, ids in enumerate(cohorts):
            assert_metrics_close(ref.run_round(j, ids, r),
                                 port.run_round(j, ids, r))
    for j in range(2):
        assert param_err(ref.params_of(j), port.params_of(j)) <= 1e-4
    with pytest.raises(ValueError, match="differs"):
        port.begin_round(0, np.asarray([1, 2]), 9)
        port.begin_round(1, np.asarray([3, 4]), 9)
        port.run_round(0, np.asarray([1, 2]), 9)
        port.run_round(1, np.asarray([5, 6]), 9)


def test_counters_count_what_local_sgd_trains(monkeypatch):
    """``counters()`` against the batches the SGD loop is handed: one
    vmapped step a batch and epoch, the cohort's samples in each."""
    _, jobs, datasets = setup(num_jobs=2)
    port = rt.FusedMultiRuntime(jobs, datasets, seed=0, device="cpu")
    seen = dict(rounds=0, samples=0, sgd_steps=0)
    sgd = rt._sgd

    def counted(params, grad_fn, xb, yb, steps, epochs, lr, axis):
        n, steps_, batch = xb.shape[:3]
        assert steps_ == steps
        seen["rounds"] += 1
        seen["samples"] += n * steps * batch * epochs
        seen["sgd_steps"] += steps * epochs
        return sgd(params, grad_fn, xb, yb, steps, epochs, lr, axis)

    monkeypatch.setattr(rt, "_sgd", counted)
    rng = np.random.default_rng(5)
    flushes = 0
    for r in range(3):
        cohorts = [rng.choice(NUM_DEV, int(rng.integers(2, 8)), replace=False)
                   for _ in jobs]
        for j, ids in enumerate(cohorts):
            port.begin_round(j, ids, r)
        for j, ids in enumerate(cohorts):
            port.run_round(j, ids, r)
        flushes += 1
    assert port.counters() == dict(flushes=flushes, **seen)
    assert seen["rounds"] == 6 and seen["samples"] > 0
    assert rt._batches(0, 4) == (0, 0) and rt._batches(3, 4) == (1, 3)


def test_traced_flush_names_its_phases_and_cause():
    """Traced, a flush is a ``fused_round`` span holding each job's
    ``gather``, ``local_sgd``, ``fedavg`` and ``eval`` spans, and emits the
    runtime's counters; on the CPU no device range is recorded."""
    from repro_torch.monitoring import trace

    _, jobs, datasets = setup(num_jobs=2)
    port = rt.FusedMultiRuntime(jobs, datasets, seed=0, device="cpu")
    ids = [np.arange(3), np.arange(4, 9)]
    tracer = trace.get_tracer()
    tracer.clear()
    trace.enable()
    try:
        for j in range(2):
            port.begin_round(j, ids[j], 0)
        port.run_round(1, ids[1], 0)
        port.run_round(0, ids[0], 0)
    finally:
        trace.disable()
    events = tracer.events()
    assert tracer.device_events() == []
    tracer.clear()
    spans = [e for e in events if e["ph"] == "X"]
    (flush,) = [e for e in spans if e["name"] == "fused_round"]
    assert flush["args"] == dict(jobs=2, eval=True, trigger=(1, 0),
                                 trains=[(0, 0), (1, 0)])
    phases = [(e["name"], e["args"]["job"]) for e in spans
              if e["name"] not in ("fused_round", "metrics_sync")]
    assert phases == [(p, j) for j in range(2)
                      for p in ("gather", "local_sgd", "fedavg", "eval")]
    end = flush["ts"] + flush["dur"]
    for e in spans:
        if e["name"] != "metrics_sync":
            assert flush["ts"] <= e["ts"] and e["ts"] + e["dur"] <= end
            if e is not flush:
                assert e["args"] == dict(job=e["args"]["job"], round=0,
                                         model="tiny")
    counts = {e["name"]: e["args"][e["name"]] for e in events
              if e["ph"] == "C"}
    assert counts == port.counters()
    assert counts["rounds"] == 2 and counts["flushes"] == 1


def test_eval_every_matches_reference():
    ref_jobs, jobs, datasets = setup(seed=11)
    ref = ref_rt.FusedMultiRuntime(ref_jobs, datasets, seed=0, eval_every=3)
    port = rt.FusedMultiRuntime(jobs, datasets, seed=0, eval_every=3,
                                device="cpu")
    rng = np.random.default_rng(4)
    got = []
    for r in range(7):
        ids = rng.choice(NUM_DEV, 5, replace=False)
        a, b = ref.run_round(0, ids, r), port.run_round(0, ids, r)
        assert_metrics_close(a, b)
        got.append(b)
    assert got[0] == got[1] == got[2] and got[3] == got[4] == got[5]
    assert got[3] != got[0] and got[6] != got[3]


@pytest.mark.parametrize("mode", ["nan", "scale"])
def test_robust_mode_matches_reference(mode):
    """Corruption injected from the same keyed fault schedule in both
    packages; the same lanes are rejected every round."""
    ref_jobs, jobs, datasets = setup(seed=3)
    kw = dict(corrupt_rate=0.3, corrupt_mode=mode, corrupt_scale=40.0,
              seed=9)
    ref = ref_rt.FusedMultiRuntime(
        ref_jobs, datasets, seed=0, robust=True, reject_mult=3.0,
        fault_engine=RefFaultEngine(RefFaultSpec(**kw), NUM_DEV))
    port = rt.FusedMultiRuntime(
        jobs, datasets, seed=0, robust=True, reject_mult=3.0,
        fault_engine=FaultEngine(FaultSpec(**kw), NUM_DEV), device="cpu")
    assert port.handles_corruption
    rng = np.random.default_rng(5)
    for r in range(5):
        ids = rng.choice(NUM_DEV, 8, replace=False)
        assert_metrics_close(ref.run_round(0, ids, r),
                             port.run_round(0, ids, r))
    assert port.rejected_total == ref.rejected_total > 0
    assert np.isfinite(port.run_round(0, np.arange(8), 5)["loss"])


def real_fl_specs(fused=True):
    """``real-fl-two-job`` from both packages, shrunk (10 devices, 2 rounds,
    1000 samples per job, 100 eval samples) and on greedy (closed-form
    decisions, so the training path is what the test compares)."""
    out = []
    for mod in (ref_presets, presets):
        spec = mod.get_preset("real-fl-two-job", scheduler="greedy",
                              rounds=2, num_devices=10)
        out.append(spec.replace(
            runtime_kwargs={"samples_per_job": 1000, "eval_samples": 100},
            train={"fused": fused}))
    return out


@pytest.mark.parametrize("fused", [True, False])
def test_real_fl_experiment_matches_reference(fused):
    ref_spec, spec = real_fl_specs(fused)
    assert spec.to_dict() == ref_spec.to_dict()
    a, b = ref_spec.run(), spec.run(device="cpu")
    assert len(a.records) == len(b.records) == 4
    for ra, rb in zip(a.records, b.records):
        np.testing.assert_array_equal(ra.device_ids, rb.device_ids)
        assert ra.round_time == rb.round_time and ra.t_end == rb.t_end
        assert_metrics_close(dict(loss=ra.loss, accuracy=ra.accuracy),
                             dict(loss=rb.loss, accuracy=rb.accuracy), 100)


def test_reference_params_carried_across_after_round_1():
    """Round 1 on the reference; its params cross to the port (numpy, as
    ``jax.device_get`` gives them); both then train round 2 alike."""
    ref_spec, spec = real_fl_specs()
    ref = ref_spec.build().engine.runtime
    port = spec.build(device="cpu").engine.runtime
    rng = np.random.default_rng(6)
    first = [rng.choice(10, 5, replace=False) for _ in range(2)]
    second = [rng.choice(10, 5, replace=False) for _ in range(2)]
    for j in range(2):
        ref.run_round(j, first[j], 0)
        carried = jax.device_get(ref.params_of(j))
        port.load_params(j, carried)
        back = convert.cnn_params_to_reference(port.params_of(j))
        for a, b in zip(jax.tree_util.tree_leaves(carried),
                        jax.tree_util.tree_leaves(back)):
            np.testing.assert_array_equal(a, b)
    for j in range(2):
        assert_metrics_close(ref.run_round(j, second[j], 1),
                             port.run_round(j, second[j], 1), 100)
        assert param_err(ref.params_of(j), port.params_of(j)) <= 1e-5
    tensors = convert.cnn_params_from_reference(
        jax.device_get(ref.params_of(0)), device="cpu")
    for a, b in zip(jax.tree_util.tree_leaves(ref.params_of(0)),
                    tree_leaves(tensors)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    bad = jax.device_get(ref.params_of(0))
    bad[0]["b"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="shape"):
        port.load_params(0, bad)


def test_unfused_weights_by_partition_size_like_reference():
    ref_jobs, jobs, datasets = setup(seed=13)
    x, y, part, ex, ey = datasets[0]
    sizes = np.full(NUM_DEV, part.shape[1], dtype=np.float64)
    sizes[:NUM_DEV // 2] = part.shape[1] // 3
    ref = ref_rt.FLJobRuntime(ref_jobs[0], x, y, part, ex, ey, seed=0,
                              partition_sizes=sizes)
    port = rt.FLJobRuntime(jobs[0], x, y, part, ex, ey, seed=0,
                           partition_sizes=sizes, device="cpu")
    ids = np.asarray([1, 4, 15, 18])
    assert_metrics_close(ref.run_round(0, ids, 0), port.run_round(0, ids, 0))
    assert param_err(ref.params, port.params) <= 1e-5


def test_runtime_rejects_bad_args():
    _, jobs, datasets = setup()
    with pytest.raises(ValueError):
        rt.FusedMultiRuntime(jobs, [], device="cpu")
    with pytest.raises(ValueError):
        rt.FusedMultiRuntime(jobs, datasets, eval_every=0, device="cpu")
    with pytest.raises(ValueError):
        rt.FLJobRuntime(jobs[0], *datasets[0],
                        partition_sizes=np.ones(NUM_DEV + 1), device="cpu")
    fused = rt.FusedMultiRuntime(jobs, datasets, buckets=(4, 8),
                                 device="cpu")
    assert fused.buckets == (4, 8, NUM_DEV)


def test_cuda_device_without_card_raises():
    """No fallback: on a machine without a card, ``device="cuda"`` raises
    instead of training on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the CPU-only case")
    _, spec = real_fl_specs()
    with pytest.raises((RuntimeError, AssertionError)):
        spec.build(device="cuda")


def test_group_a_lr_diverges_alike():
    """Group A's lr of 0.05 (batch 30, 5 epochs) blows LeNet-5's loss up on
    this synthetic data in the reference, and the port follows it: the
    divergence is the shared math's, not the port's (VGG16 reaches NaN
    there, so the card runs VGG16 at a lower lr)."""
    from repro.experiment.spec import ExperimentSpec as RefSpec
    from repro.experiment.spec import JobSpec as RefJob
    from repro.experiment.spec import PoolSpec as RefPool
    from repro_torch.experiment.spec import ExperimentSpec, JobSpec, PoolSpec

    losses = []
    for S, J, P, kw in ((RefSpec, RefJob, RefPool, {}),
                        (ExperimentSpec, JobSpec, PoolSpec,
                         {"device": "cpu"})):
        spec = S(name="lr", jobs=(J(name="l", model="paper-lenet5",
                                    max_rounds=1, local_epochs=5,
                                    batch_size=30, lr=0.05),),
                 pool=P(num_devices=20, seed=5), scheduler="greedy",
                 runtime="real_fl", n_sel=3,
                 runtime_kwargs={"eval_samples": 100})
        losses.append(spec.run(**kw).records[0].loss)
    assert losses[0] > 1e3
    # A diverging run amplifies the last-bit differences of the matmul
    # order far beyond the 1e-4 of a stable one: within 1%.
    assert abs(losses[0] - losses[1]) <= 1e-2 * losses[0]
