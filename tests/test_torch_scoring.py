"""Port scoring core vs the reference on the same numpy inputs.

- ``numpy`` is bit-identical to the reference's ``numpy`` backend;
- ``torch`` on the CPU and ``cuda`` with ``device="cpu"`` (the kernel
  wrapper's plain version plus the float64 host combine) match the
  reference's jitted ``jax`` backend within ``TOL`` (tests/test_scoring.py);
- dense and index forms, both fairness modes, empty plans, large counts.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import scoring as ref_scoring  # noqa: E402
from repro.core.cost import CostModel as RefCostModel  # noqa: E402
from repro.core.devices import DevicePool as RefDevicePool  # noqa: E402
from repro_torch.core import scoring  # noqa: E402
from repro_torch.core.cost import CostModel  # noqa: E402
from repro_torch.core.devices import DevicePool  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
KW = dict(alpha=4.0, beta=0.25, time_scale=3.0, fairness_scale=0.09)
DEVICE_BACKENDS = ("torch", "cuda")


def make_problem(seed, K, P, count_hi=50, allow_empty=True):
    rng = np.random.default_rng(seed)
    times = rng.uniform(0.1, 100.0, K)
    counts = rng.integers(0, count_hi, K).astype(np.float64)
    plans = rng.random((P, K)) < rng.uniform(0.05, 0.6)
    plans &= (rng.random(K) < 0.8)[None, :]
    if allow_empty and P > 1:
        plans[rng.integers(0, P)] = False
    return times, counts, plans


CASES = [(s, K, P) for s, (K, P) in enumerate(
    [(50, 8), (257, 33), (1000, 16), (999, 3), (64, 1)])]


@pytest.mark.parametrize("seed,K,P", CASES)
@pytest.mark.parametrize("delta", [True, False])
def test_numpy_backend_bit_identical(seed, K, P, delta):
    times, counts, plans = make_problem(seed, K, P)
    a = ref_scoring.score_plans(times, counts, plans, backend="numpy",
                                delta_fairness=delta, **KW)
    b = scoring.score_plans(times, counts, plans, backend="numpy",
                            delta_fairness=delta, **KW)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed,K,P", CASES)
@pytest.mark.parametrize("delta", [True, False])
@pytest.mark.parametrize("backend", DEVICE_BACKENDS)
def test_device_backends_match_jax(seed, K, P, delta, backend):
    times, counts, plans = make_problem(seed, K, P)
    a = ref_scoring.score_plans(times, counts, plans, backend="jax",
                                delta_fairness=delta, **KW)
    b = scoring.score_plans(times, counts, plans, backend=backend,
                            device="cpu", delta_fairness=delta, **KW)
    np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("seed,K,P", CASES)
@pytest.mark.parametrize("delta", [True, False])
def test_index_form_matches_reference(seed, K, P, delta):
    rng = np.random.default_rng(100 + seed)
    times, counts, _ = make_problem(seed, K, P)
    n_sel = max(1, K // 10)
    idx = np.stack([rng.choice(K, n_sel, replace=False) for _ in range(P)])
    kw = dict(delta_fairness=delta, **KW)
    np.testing.assert_array_equal(
        ref_scoring.score_plan_indices(times, counts, idx, backend="numpy",
                                       **kw),
        scoring.score_plan_indices(times, counts, idx, backend="numpy", **kw))
    a = ref_scoring.score_plan_indices(times, counts, idx, backend="jax", **kw)
    for backend in DEVICE_BACKENDS:
        b = scoring.score_plan_indices(times, counts, idx, backend=backend,
                                       device="cpu", **kw)
        np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("backend", ("numpy",) + DEVICE_BACKENDS)
def test_empty_plans_score_zero_time(backend):
    times = np.linspace(1, 10, 20)
    counts = np.zeros(20)
    plans = np.zeros((3, 20), dtype=bool)
    out = scoring.score_plans(times, counts, plans, alpha=1.0, beta=0.0,
                              backend=backend, device="cpu")
    np.testing.assert_allclose(out, 0.0, atol=1e-7)
    idx = np.zeros((2, 0), dtype=np.int64)
    for delta in (True, False):
        np.testing.assert_array_equal(
            scoring.score_plan_indices(times, counts + 3.0, idx,
                                       delta_fairness=delta, backend=backend,
                                       device="cpu"),
            ref_scoring.score_plan_indices(times, counts + 3.0, idx,
                                           delta_fairness=delta,
                                           backend="numpy"))


@pytest.mark.parametrize("backend", DEVICE_BACKENDS)
def test_large_counts_no_cancellation(backend):
    """Fleet regime: cumulative counts ~1e4 must not destroy f32 parity
    (the f64 mean-centring), at the reference test's tolerance."""
    times, counts, plans = make_problem(3, 256, 16, count_hi=10_000)
    kw = dict(delta_fairness=True, **KW)
    a = ref_scoring.score_plans(times, counts, plans, backend="numpy", **kw)
    b = ref_scoring.score_plans(times, counts, plans, backend="jax", **kw)
    c = scoring.score_plans(times, counts, plans, backend=backend,
                            device="cpu", **kw)
    np.testing.assert_allclose(a, c, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(b, c, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("delta", [True, False])
def test_round_time_and_fairness_batch(delta):
    times, counts, plans = make_problem(7, 300, 12)
    np.testing.assert_array_equal(
        scoring.round_time_batch(times, plans, backend="numpy"),
        ref_scoring.round_time_batch(times, plans, backend="numpy"))
    np.testing.assert_array_equal(
        scoring.fairness_batch(counts, plans, delta, backend="numpy"),
        ref_scoring.fairness_batch(counts, plans, delta, backend="numpy"))
    for backend in DEVICE_BACKENDS:
        np.testing.assert_allclose(
            scoring.round_time_batch(times, plans, backend=backend,
                                     device="cpu"),
            ref_scoring.round_time_batch(times, plans, backend="jax"), **TOL)
        np.testing.assert_allclose(
            scoring.fairness_batch(counts, plans, delta, backend=backend,
                                   device="cpu"),
            ref_scoring.fairness_batch(counts, plans, delta, backend="jax"),
            **TOL)


def test_auto_dispatch_thresholds():
    assert scoring.resolve_backend("auto", scoring.AUTO_NUMPY_MAX_DENSE) \
        == "numpy"
    assert scoring.resolve_backend("auto", scoring.AUTO_NUMPY_MAX_DENSE + 1) \
        == "torch"
    assert scoring.resolve_backend("auto", scoring.AUTO_NUMPY_MAX_DENSE + 1,
                                   form="index") == "numpy"
    with pytest.raises(ValueError):
        scoring.resolve_backend("jax", 10)


def test_cost_model_batch_matches_reference():
    pool, ref_pool = (cls.heterogeneous(64, 2, seed=0)
                      for cls in (DevicePool, RefDevicePool))
    cm = CostModel(pool, alpha=4.0, beta=0.25, device="cpu")
    ref_cm = RefCostModel(ref_pool, alpha=4.0, beta=0.25)
    cm.calibrate([5.0, 5.0], n_sel=8)
    ref_cm.calibrate([5.0, 5.0], n_sel=8)
    assert (cm.time_scale, cm.fairness_scale) == \
        (ref_cm.time_scale, ref_cm.fairness_scale)
    rng = np.random.default_rng(1)
    counts = rng.integers(0, 5, 64).astype(float)
    plans = rng.random((10, 64)) < 0.2
    times = pool.expected_times(0, 5.0)
    np.testing.assert_array_equal(
        cm.cost_batch(times, counts, plans, backend="numpy"),
        ref_cm.cost_batch(times, counts, plans, backend="numpy"))
    for backend in DEVICE_BACKENDS:
        np.testing.assert_allclose(
            cm.cost_batch(times, counts, plans, backend=backend),
            ref_cm.cost_batch(times, counts, plans, backend="jax"), **TOL)


def test_cuda_backend_without_gpu_raises():
    """No silent fallback: the cuda backend on device="cuda" raises where
    there is no GPU (checked inside the test, never at import)."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the no-GPU contract cannot be shown")
    times, counts, plans = make_problem(0, 300, 1000)
    with pytest.raises(RuntimeError, match="cuda"):
        scoring.score_plans(times, counts, plans, backend="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        scoring.plan_stats_cuda(times, counts, plans)
    pool = DevicePool.heterogeneous(32, 1, seed=0)
    with pytest.raises(RuntimeError, match="cuda"):
        CostModel(pool, scoring_backend="cuda").cost_batch(
            times[:32], counts[:32], plans[:2, :32])
