"""Port kernel plain version vs the reference: ``plan_stats_ref`` (the
plain PyTorch version of the CUDA plan-scoring kernel) against the Pallas
kernel in interpret mode and against ``repro.kernels.ref.sched_plan_stats``,
on the same numpy inputs. Columns 0 (masked max) and 1 (count) must be
exact; column 2 (a float32 sum taken in another order) within 1e-5."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import scoring as ref_scoring  # noqa: E402
from repro.kernels import ref as ref_kernels  # noqa: E402
from repro_torch.kernels import ops, sched_score  # noqa: E402

SUM_TOL = dict(rtol=1e-5, atol=1e-5)

SHAPES = [(1, 1000), (37, 1001), (64, 512), (5, 16), (3, 1)]


def make_stats_problem(seed, P, K, density=0.1):
    rng = np.random.default_rng(seed)
    times = rng.uniform(0.1, 100.0, K).astype(np.float32)
    counts = rng.integers(0, 50, K).astype(np.float64)
    plans = rng.random((P, K)) < density
    if P > 2:
        plans[0] = False   # an empty plan
        plans[1] = True    # every device selected
    return times, counts, plans


def port_stats(times, counts, plans, impl="ref"):
    w = 2.0 * np.asarray(counts, np.float32) + 1.0
    out = ops.sched_plan_stats(torch.from_numpy(times), torch.from_numpy(w),
                               torch.from_numpy(plans.view(np.int8)),
                               impl=impl)
    return out.numpy()


def assert_stats_match(got, exp):
    np.testing.assert_array_equal(got[:, 0], exp[:, 0])
    np.testing.assert_array_equal(got[:, 1], exp[:, 1])
    np.testing.assert_allclose(got[:, 2], exp[:, 2], **SUM_TOL)


@pytest.mark.parametrize("P,K", SHAPES)
def test_plan_stats_ref_matches_pallas_interpret(P, K):
    times, counts, plans = make_stats_problem(P * 7919 + K, P, K)
    exp = ref_scoring.plan_stats_pallas(times, counts, plans, interpret=True)
    assert_stats_match(port_stats(times, counts, plans), exp)


@pytest.mark.parametrize("P,K", SHAPES)
def test_plan_stats_ref_matches_jnp_oracle(P, K):
    times, counts, plans = make_stats_problem(P * 31 + K, P, K)
    w = 2.0 * counts.astype(np.float32) + 1.0
    exp = np.asarray(ref_kernels.sched_plan_stats(
        jnp.asarray(times), jnp.asarray(w), jnp.asarray(plans.astype(np.int8))))
    assert_stats_match(port_stats(times, counts, plans), exp)


def test_inf_times_on_unselected_devices_stay_out():
    """Crashed devices carry +inf times; a select (never a mask product)
    keeps them out of plans that do not pick them."""
    times, counts, plans = make_stats_problem(5, 9, 300)
    times[::7] = np.inf
    plans[2:, ::7] = False
    got = port_stats(times, counts, plans)
    w = 2.0 * counts.astype(np.float32) + 1.0
    exp = np.asarray(ref_kernels.sched_plan_stats(
        jnp.asarray(times), jnp.asarray(w), jnp.asarray(plans.astype(np.int8))))
    assert_stats_match(got, exp)
    assert np.isinf(got[1, 0]) and np.all(np.isfinite(got[2:, 0]))
    assert got[0, 0] == np.float32(sched_score.NEG_INF)


def test_cuda_impl_on_cpu_tensors_is_the_plain_version():
    """The kernel wrapper takes the plain version only for CPU tensors, and
    counts no launch for it."""
    times, counts, plans = make_stats_problem(11, 16, 257)
    before = sched_score.launches
    got = port_stats(times, counts, plans, impl="cuda")
    assert sched_score.launches == before
    np.testing.assert_array_equal(got, port_stats(times, counts, plans))


def test_plan_stats_accepts_bool_and_rejects_bad_inputs():
    t = torch.ones(8)
    w = torch.ones(8)
    p = torch.zeros((2, 8), dtype=torch.bool)
    p[1, 3] = True
    out = sched_score.plan_stats(t, w, p)
    assert out.shape == (2, 3) and out.dtype == torch.float32
    assert out[1].tolist() == [1.0, 1.0, 1.0]
    with pytest.raises(TypeError):
        sched_score.plan_stats(t.double(), w, p)
    with pytest.raises(TypeError):
        sched_score.plan_stats(t, w, p.to(torch.int32))
    with pytest.raises(TypeError):
        sched_score.plan_stats(t[:4], w, p)
    with pytest.raises(ValueError):
        ops.sched_plan_stats(t, w, p, impl="emulate")


def test_weight_sum_independent_of_positions():
    """Plans selecting the same multiset of weights get the same column 2
    wherever the devices sit (the host searchers' exact ties)."""
    rng = np.random.default_rng(2)
    K = 4000
    w = np.full(K, np.float32(0.98))
    w[rng.choice(K, 50, replace=False)] = np.float32(2.98)
    heavy = np.flatnonzero(w > 2)
    light = np.flatnonzero(w < 2)
    plans = np.zeros((6, K), dtype=bool)
    for r in range(6):
        plans[r, rng.choice(heavy, 7, replace=False)] = True
        plans[r, rng.choice(light, 93, replace=False)] = True
    out = sched_score.plan_stats_ref(torch.ones(K), torch.from_numpy(w),
                                     torch.from_numpy(plans)).numpy()
    assert np.all(out[:, 2] == out[0, 2])
