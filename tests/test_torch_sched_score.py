"""Which variant of the plan-scoring kernel (``csrc/sched_score.cu``)
serves a call: a pure function of the shape and the plans pointer's
alignment, checked here on the CPU at the shapes ``chip_smoke.py`` phase 2
times and at the edges.
The kernels themselves are held to ``plan_stats_ref`` on the card
(``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, sched_score as ss  # noqa: E402

PHASE2 = [  # label, P, K, the variant on aligned plans
    ("sa", 1, 10_000, "stream"),
    ("genetic-fleet-scale", 512, 10_000, "stream"),
    ("readme-fleet-block", 4096, 100_000, "stream"),
    ("ragged", 37, 1001, "row"),
    ("edges-aligned", 64, 10_000, "stream"),
]


@pytest.mark.parametrize("label,P,K,want", PHASE2)
def test_kernel_variant_on_phase2_shapes(label, P, K, want):
    assert ss.kernel_variant(P, K, True) == want
    assert ss.serves(want, P, K, True)
    assert ss.kernel_variant(P, K, False) == "row"


@pytest.mark.parametrize("P,K,aligned,want", [
    (0, 10_000, True, "stream"), (1, 10_000, True, "stream"),
    (0, 1001, True, "row"), (1, 1, True, "row"), (64, 1, True, "row"),
    (3, 16, True, "stream"), (3, 16, False, "row"), (37, 1001, True, "row"),
    (8, 262_144, True, "stream"), (8, 262_144, False, "row"),
    (5, 0, True, "row"), (1, 1008, True, "stream"), (1, 1000, True, "row")])
def test_kernel_variant_edges(P, K, aligned, want):
    assert ss.kernel_variant(P, K, aligned) == want
    assert ss.serves(want, P, K, aligned)


@pytest.mark.parametrize("P,K,aligned,want", [
    (1, 16, True, True), (1, 16, False, False), (1, 1, True, False),
    (1, 0, True, False), (9, 1001, True, False), (9, 1008, True, True),
    (4096, 100_000, True, True), (0, 32, True, True)])
def test_serves_stream(P, K, aligned, want):
    assert ss.serves("stream", P, K, aligned) is want
    assert ss.serves("row", P, K, aligned) is True


def test_serves_names_only_its_variants():
    with pytest.raises(ValueError):
        ss.serves("nonesuch", 1, 16, True)


@pytest.mark.parametrize("P", [0, 1, 2, 64, 131, 132, 133, 512, 528,
                               529, 4096])
@pytest.mark.parametrize("K", [1, 16, 1001, 10_000, 100_000, 262_144])
def test_kernel_variant_does_not_depend_on_rows(P, K):
    """No row count changes the pick: ``stream``'s persistent grid takes
    any P (one row a block up to the resident blocks, several beyond), so
    the rule has no threshold in P."""
    assert ss.kernel_variant(P, K, True) == ss.kernel_variant(1, K, True)
    assert ss.kernel_variant(P, K, False) == "row"
    for v in ss.VARIANTS:
        assert ss.serves(v, P, K, True) == ss.serves(v, 1, K, True)


def test_plain_path_on_cpu_counts_no_launch():
    """CPU tensors take the plain version: neither ``launches`` nor
    ``launches_by_variant`` moves."""
    rng = np.random.default_rng(4)
    K, P = 1008, 12
    times = torch.from_numpy(rng.uniform(0.1, 100.0, K).astype(np.float32))
    w = torch.from_numpy(rng.integers(0, 9, K).astype(np.float32))
    plans = torch.from_numpy(rng.random((P, K)) < 0.05)
    before, before_v = ss.launches, dict(ss.launches_by_variant)
    got = ops.sched_plan_stats(times, w, plans, impl="cuda")
    assert ss.launches == before
    assert ss.launches_by_variant == before_v
    assert set(before_v) == set(ss.VARIANTS)
    torch.testing.assert_close(got, ss.plan_stats_ref(times, w, plans),
                               rtol=0, atol=0)
