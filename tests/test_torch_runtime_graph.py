"""``FusedMultiRuntime``'s local SGD replayed from CUDA graphs, on the card,
against the eager path (``FLJobRuntime``, the same math launched kernel by
kernel): parameters and metrics bit for bit, the captures, replays and
eager steps ``graph_counters()`` counts, a new cohort size, two groups'
graphs sharing one memory pool, and the parameters ``params_of`` hands
out. Each model of the benchmark's two
groups at its cell's batch, cohort size and learning rate, on shards of two
batches. The card tests are marked ``requires_cuda`` and skip without a
card, decided inside the fixture; run them on a GPU machine with

    PYTHONPATH=src python -m pytest -q -m requires_cuda \
        tests/test_torch_runtime_graph.py

One CPU test: there the runtime runs eagerly and counts no graph work.
Imports neither jax nor the reference.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.config.base import JobConfig  # noqa: E402
from repro_torch.config.registry import get_arch  # noqa: E402
from repro_torch.configs.paper_models import lenet5  # noqa: E402
from repro_torch.fl import runtime as rt  # noqa: E402
from repro_torch.monitoring import trace  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

EPOCHS = 2
EVAL = 64

#: (model, cohort size, batch, lr) of each job of the benchmark's cells
CELL_JOBS = [
    ("paper-vgg16", 10, 30, 0.001),
    ("paper-cnn-a-noniid", 10, 10, 0.002),
    ("paper-lenet5", 10, 64, 0.01),
    ("paper-resnet18", 100, 30, 0.0001),
    ("paper-cnn-b", 100, 10, 0.005),
    ("paper-alexnet", 100, 64, 0.005),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    yield torch.device("cuda")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def dataset(cfg, devices: int, width: int, seed: int):
    """Random images and labels, each device ``width`` samples of its own."""
    rng = np.random.default_rng(seed)
    shape = tuple(cfg.input_shape)
    x = rng.standard_normal((devices * width,) + shape, dtype=np.float32)
    y = rng.integers(0, cfg.num_classes, devices * width)
    part = rng.permutation(devices * width).reshape(devices, width)
    ex = rng.standard_normal((EVAL,) + shape, dtype=np.float32)
    ey = rng.integers(0, cfg.num_classes, EVAL)
    return x, y, part, ex, ey


def job(model, batch, lr, job_id=0):
    return JobConfig(job_id=job_id, model=get_arch(model), target_metric=2.0,
                     local_epochs=EPOCHS, batch_size=batch, lr=lr)


def assert_equal_params(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for u, v in zip(la, lb):
        assert torch.equal(u, v)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("model,n,batch,lr", CELL_JOBS,
                         ids=[m for m, *_ in CELL_JOBS])
def test_graph_rounds_match_eager_bit_for_bit(cuda, model, n, batch, lr):
    """Three rounds, the first eager, the second captured, all replayed
    after it: the parameters and metrics of every round are the eager
    path's, and every step after the first round is a replay."""
    j = job(model, batch, lr)
    data = dataset(j.model, n + 4, 2 * batch, seed=1)
    fused = rt.FusedMultiRuntime([j], [data], seed=3, device=cuda)
    eager = rt.FLJobRuntime(j, *data, seed=3, device=cuda)
    rng = np.random.default_rng(2)
    for r in range(3):
        ids = rng.choice(n + 4, n, replace=False)
        assert fused.run_round(0, ids, r) == eager.run_round(0, ids, r)
        assert_equal_params(fused.params_of(0), eager.params)
    steps = 2 * EPOCHS
    assert fused.graph_counters() == dict(captures=1, replays=2 * steps,
                                          eager_steps=steps)
    assert fused.counters()["sgd_steps"] == 3 * steps


@pytest.mark.requires_cuda
def test_graph_counts_per_group_and_cohort_size(cuda):
    """Two jobs of one model share their group's graph, which the first
    job's round at a size warms up and the second's captures; a cohort of a
    new size does the same once more. A job of another model forms a second
    group, whose graphs replay between the first group's out of the same
    memory pool, all bit for bit the eager path's. A traced flush emits the
    counts."""
    specs = [CELL_JOBS[1], CELL_JOBS[1], CELL_JOBS[2]]
    jobs = [job(model, batch, lr, job_id=m)
            for m, (model, _, batch, lr) in enumerate(specs)]
    n = specs[0][1]
    data = [dataset(j.model, n + 4, 2 * j.batch_size, seed=m)
            for m, j in enumerate(jobs)]
    fused = rt.FusedMultiRuntime(jobs, data, seed=0, device=cuda)
    eagers = [rt.FLJobRuntime(j, *data[m], seed=m, device=cuda)
              for m, j in enumerate(jobs)]
    assert len(fused.groups) == 2
    steps = 2 * EPOCHS
    rng = np.random.default_rng(7)
    sizes = [n, n, n, n - 3, n - 3, n - 3]
    tracer = trace.get_tracer()
    for r, size in enumerate(sizes):
        cohorts = [rng.choice(n + 4, size, replace=False) for _ in jobs]
        for m in range(len(jobs)):
            fused.begin_round(m, cohorts[m], r)
        if r == len(sizes) - 1:
            tracer.clear()
            trace.enable()
        try:
            for m in range(len(jobs)):
                assert (fused.run_round(m, cohorts[m], r)
                        == eagers[m].run_round(m, cohorts[m], r))
        finally:
            trace.disable()
        for m in range(len(jobs)):
            assert_equal_params(fused.params_of(m), eagers[m].params)
    got = fused.graph_counters()
    # per group and size: its first job round eager, the next captures,
    # and every step after the first job round replayed
    firsts = 2 * 2
    assert got == dict(captures=4,
                       replays=(len(jobs) * len(sizes) - firsts) * steps,
                       eager_steps=firsts * steps)
    events = {e["name"]: e["args"][e["name"]] for e in tracer.events()
              if e["ph"] == "C"}
    tracer.clear()
    assert events == dict(fused.counters(), sgd_graph_captures=4,
                          sgd_graph_replays=got["replays"],
                          sgd_eager_steps=got["eager_steps"])


@pytest.mark.requires_cuda
def test_params_handed_out_stay_fresh(cuda):
    """Parameters ``params_of`` returned before a flush are FedAvg's own
    output, not a graph's static buffer: two later flushes, both replayed,
    leave them unchanged."""
    _, n, batch, lr = CELL_JOBS[2]
    j = job("paper-lenet5", batch, lr)
    fused = rt.FusedMultiRuntime([j], [dataset(j.model, n, 2 * batch, 5)],
                                 seed=0, device=cuda)
    ids = np.arange(n)
    for r in range(2):
        fused.run_round(0, ids, r)
    held = fused.params_of(0)
    kept = [leaf.clone() for leaf in tree_leaves(held)]
    for r in range(2, 4):
        fused.run_round(0, ids, r)
    assert fused.graph_counters()["replays"] == 3 * 2 * EPOCHS
    for leaf, copy in zip(tree_leaves(held), kept):
        assert torch.equal(leaf, copy)
    assert not torch.equal(tree_leaves(fused.params_of(0))[0], kept[0])


def test_cpu_counts_no_graph_work():
    """On the CPU local SGD runs eagerly: every graph count stays 0."""
    cfg = dataclasses.replace(
        lenet5(), name="tiny", input_shape=(8, 8, 1),
        cnn_spec=(("convp", 4, 3), ("flatten",), ("fc", 16)))
    j = JobConfig(job_id=0, model=cfg, target_metric=2.0, local_epochs=2,
                  batch_size=4, lr=0.05)
    fused = rt.FusedMultiRuntime([j], [dataset(cfg, 6, 8, seed=0)], seed=0,
                                 device="cpu")
    for r in range(3):
        fused.run_round(0, np.arange(4), r)
    assert fused.counters()["sgd_steps"] == 3 * 2 * 2
    assert fused.graph_counters() == dict(captures=0, replays=0,
                                          eager_steps=0)
