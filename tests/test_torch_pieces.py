"""Port pieces vs the reference from the same seeds: plans, the device pool
(coefficients, sampling, churn, the bf16 mirror to 0 ulp) and the fault
engine must give identical arrays."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import plans as ref_plans  # noqa: E402
from repro.core.devices import DevicePool as RefDevicePool  # noqa: E402
from repro.faults import FaultEngine as RefFaultEngine  # noqa: E402
from repro.faults import FaultSpec as RefFaultSpec  # noqa: E402
from repro_torch.core import plans  # noqa: E402
from repro_torch.core.devices import DevicePool  # noqa: E402
from repro_torch.faults import FaultEngine, FaultSpec  # noqa: E402


def twin_rngs(seed):
    return np.random.default_rng(seed), np.random.default_rng(seed)


@pytest.mark.parametrize("seed", range(3))
def test_plan_primitives_identical(seed):
    K, n_sel = 200, 17
    avail = np.random.default_rng(seed).random(K) < 0.7
    r1, r2 = twin_rngs(seed)
    np.testing.assert_array_equal(
        ref_plans.random_plan_indices(r1, avail, n_sel, 9),
        plans.random_plan_indices(r2, avail, n_sel, 9))
    np.testing.assert_array_equal(
        ref_plans.random_plans(r1, avail, n_sel, 5, dtype=np.int8),
        plans.random_plans(r2, avail, n_sel, 5, dtype=np.int8))
    logits = np.random.default_rng(seed + 9).normal(size=(4, K))
    np.testing.assert_array_equal(
        ref_plans.gumbel_topk_plans(r1, logits, avail, n_sel),
        plans.gumbel_topk_plans(r2, logits, avail, n_sel))
    raw = np.random.default_rng(seed + 5).random((6, K)) < 0.1
    np.testing.assert_array_equal(
        ref_plans.repair_plans(r1, raw, avail, n_sel),
        plans.repair_plans(r2, raw, avail, n_sel))
    for row in raw:
        np.testing.assert_array_equal(
            ref_plans.repair_plan(r1, row.copy(), avail, n_sel),
            plans.repair_plan(r2, row.copy(), avail, n_sel))
    idx = ref_plans.random_plan_indices(r1, avail, n_sel, 3)
    np.testing.assert_array_equal(idx, plans.random_plan_indices(
        r2, avail, n_sel, 3))
    np.testing.assert_array_equal(ref_plans.indices_to_plans(idx, K),
                                  plans.indices_to_plans(idx, K))
    assert np.array_equal(r1.random(4), r2.random(4))  # same stream position


@pytest.mark.parametrize("time_dtype", [np.float64, np.float32])
def test_device_pool_identical(time_dtype):
    ref = RefDevicePool.heterogeneous(300, 3, seed=4, time_dtype=time_dtype)
    port = DevicePool.heterogeneous(300, 3, seed=4, time_dtype=time_dtype)
    for key, val in ref.state_dict().items():
        np.testing.assert_array_equal(val, port.state_dict()[key])
    for job, tau in ((0, 5.0), (2, 3.0)):
        np.testing.assert_array_equal(ref.expected_times(job, tau),
                                      port.expected_times(job, tau))
        np.testing.assert_array_equal(ref.expected_times32(job, tau),
                                      port.expected_times32(job, tau))
        # The bf16 mirror: torch.bfloat16 vs ml_dtypes, 0 ulp apart.
        np.testing.assert_array_equal(ref.expected_times_bf16(job, tau),
                                      port.expected_times_bf16(job, tau))
    np.testing.assert_array_equal(ref.expected_times_all([5.0, 3.0, 1.0]),
                                  port.expected_times_all([5.0, 3.0, 1.0]))
    np.testing.assert_array_equal(ref.sample_times(1, 5.0),
                                  port.sample_times(1, 5.0))
    np.testing.assert_array_equal(ref.sample_times(0, 2.0, size=3),
                                  port.sample_times(0, 2.0, size=3))
    np.testing.assert_array_equal(ref.sample_times_all([5.0, 3.0, 1.0]),
                                  port.sample_times_all([5.0, 3.0, 1.0]))
    # Churn mutators and occupancy, then the time model again.
    for pool in (ref, port):
        pool.set_capabilities([1, 5, 9], a=np.full(3, 1e-3), mu=2.0)
        pool.add_job()
        pool.depart([3, 4])
        pool.rejoin([4], a=np.array([5e-4]))
        pool.occupy(np.arange(300) % 7 == 0, 12.5)
        pool.fail([10], until=40.0)
    assert ref.version == port.version
    for key, val in ref.state_dict().items():
        np.testing.assert_array_equal(val, port.state_dict()[key])
    np.testing.assert_array_equal(ref.available_mask(20.0),
                                  port.available_mask(20.0))
    np.testing.assert_array_equal(ref.expected_times_bf16(3, 4.0),
                                  port.expected_times_bf16(3, 4.0))
    np.testing.assert_array_equal(ref.sample_times(3, 4.0),
                                  port.sample_times(3, 4.0))


def test_fault_engine_identical():
    kw = dict(seed=3, dropout_rate=0.2, crash_rate=0.01, straggler_rate=0.1,
              num_domains=5, domain_outage_rate=0.2, corrupt_rate=0.1)
    ref = RefFaultEngine(RefFaultSpec(**kw), 400)
    port = FaultEngine(FaultSpec(**kw), 400)
    assert FaultSpec(**kw).to_dict() == RefFaultSpec(**kw).to_dict()
    np.testing.assert_array_equal(ref.domain, port.domain)
    ids = np.arange(0, 400, 3)
    for job, rnd in ((0, 0), (1, 4), (2, 17)):
        np.testing.assert_array_equal(ref.straggler_multipliers(job, rnd),
                                      port.straggler_multipliers(job, rnd))
        for a, b in zip(ref.failure_masks(job, rnd),
                        port.failure_masks(job, rnd)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ref.corrupt_mask(job, rnd, ids),
                                      port.corrupt_mask(job, rnd, ids))
        np.testing.assert_array_equal(ref.quarantine_durations(ids[:9]),
                                      port.quarantine_durations(ids[:9]))
        ref.record_success(ids[3:5])
        port.record_success(ids[3:5])
    np.testing.assert_array_equal(ref.state_dict()["strikes"],
                                  port.state_dict()["strikes"])
    legacy = FaultSpec.from_legacy(0.1, 30.0, seed=2)
    assert legacy.to_dict() == RefFaultSpec.from_legacy(0.1, 30.0,
                                                        seed=2).to_dict()
