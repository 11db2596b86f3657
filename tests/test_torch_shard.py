"""Fleet-axis sharding in the port (``repro_torch.core.shard`` and the
``num_shards`` plumbing through scoring, the fused searches, the cost model,
the spec and the CLI) against the reference's, on the CPU. Mirrors
tests/test_fleet_shard.py class by class.

Tolerances: sharded statistics hold ``max`` and ``n`` exactly and ``wsum``
within 1e-5 relative of the reference's ``plan_stats_sharded(executor=
"emulate")``; sharded scores within 1e-5 relative of the reference's numpy
scores (as tests/test_fleet_shard.py). Both sum each block's weights in
their own order (the port in float64, rounded once, as kernel 2.1 does).
SA and GA draw every noise array from the numpy ``rng``, so split over
``[cpu] * N`` they must return the single lane's plan bit for bit, and the
reference's (or a plan of the same cost within 1e-6, an f32 tie, as
tests/test_torch_search.py holds them). BODS's candidates are a pure
function of (seed, candidate id, element), so the block at N = 4 must be
N = 1's bit for bit, with the same decision. The same paths on the card
are in tests/test_torch_cuda.py (``requires_cuda``).
"""

import json
import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core import scoring as ref_scoring  # noqa: E402
from repro.core import search as ref_search  # noqa: E402
from repro.core import shard as ref_shard  # noqa: E402
from repro.core.cost import CostModel as RefCostModel  # noqa: E402
from repro.core.devices import DevicePool as RefDevicePool  # noqa: E402
from repro.core.plans import indices_to_plans, random_plan_indices  # noqa: E402
from repro.experiment import presets as ref_presets  # noqa: E402
from repro_torch.core import scoring, search, shard  # noqa: E402
from repro_torch.core.cost import CostModel  # noqa: E402
from repro_torch.core.devices import DevicePool  # noqa: E402
from repro_torch.core.plans import validate_plan  # noqa: E402
from repro_torch.core.schedulers import get_scheduler  # noqa: E402
from repro_torch.core.schedulers.base import SchedulingContext  # noqa: E402
from repro_torch.experiment.spec import ExperimentSpec  # noqa: E402

KW = dict(alpha=4.0, beta=0.25, time_scale=3.0, fairness_scale=0.09,
          delta_fairness=True)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs several test files at once, and
    the timing-sensitive tests of other files must not be starved."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _problem(K=103, P=9, seed=0):
    """Non-power-of-two K so every shard count exercises the padding."""
    rng = np.random.default_rng(seed)
    times = rng.uniform(1.0, 100.0, K)
    counts = rng.integers(0, 50, K).astype(np.float64)
    avail = rng.random(K) < 0.8
    n_sel = max(2, int(avail.sum()) // 4)
    idx = random_plan_indices(rng, avail, n_sel, P)
    return times, counts, avail, n_sel, idx


def _rel(a, b):
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-12)))


# ---- sharded scoring parity ---------------------------------------------


class TestShardedScoringParity:
    @pytest.mark.parametrize("backend", ["torch", "cuda"])
    @pytest.mark.parametrize("form", ["dense", "index"])
    @pytest.mark.parametrize("N", [1, 2, 8])
    def test_stats_match_reference(self, N, form, backend):
        """``max`` and ``n`` exact, ``wsum`` within 1e-5; ``cuda`` on CPU
        tensors is kernel 2.1's plain version."""
        times, counts, _, _, idx = _problem()
        cc = counts - counts.mean()
        plans = idx
        if form == "dense":
            plans = indices_to_plans(idx, times.shape[0])
            plans[3] = False  # an empty row
        want = ref_shard.plan_stats_sharded(times, cc, plans, form, N,
                                            executor="emulate")
        got = shard.plan_stats_sharded(times, cc, plans, form, N,
                                       executor="emulate", backend=backend,
                                       device="cpu")
        assert got.dtype == np.float64 and got.shape == want.shape
        np.testing.assert_array_equal(got[:, 0], want[:, 0])
        np.testing.assert_array_equal(got[:, 1], want[:, 1])
        np.testing.assert_allclose(got[:, 2], want[:, 2], rtol=1e-5,
                                   atol=1e-5)

    @pytest.mark.parametrize("backend", ["torch", "cuda"])
    @pytest.mark.parametrize("N", [1, 2, 8])
    def test_index_form_matches_numpy(self, N, backend):
        times, counts, avail, n_sel, idx = _problem()
        ref = ref_scoring.score_plan_indices(times, counts, idx,
                                             backend="numpy", **KW)
        got = scoring.score_plan_indices(times, counts, idx, backend=backend,
                                         num_shards=N, device="cpu", **KW)
        assert _rel(got, ref) < 1e-5
        want = ref_scoring.score_plan_indices(times, counts, idx,
                                              backend="jax", num_shards=N,
                                              **KW)
        assert _rel(got, want) < 1e-5

    @pytest.mark.parametrize("backend", ["torch", "cuda"])
    @pytest.mark.parametrize("N", [1, 2, 8])
    def test_dense_form_matches_numpy(self, N, backend):
        times, counts, avail, n_sel, idx = _problem()
        plans = indices_to_plans(idx, times.shape[0])
        ref = ref_scoring.score_plans(times, counts, plans,
                                      backend="numpy", **KW)
        got = scoring.score_plans(times, counts, plans, backend=backend,
                                  num_shards=N, device="cpu", **KW)
        assert _rel(got, ref) < 1e-5
        want = ref_scoring.score_plans(times, counts, plans, backend="jax",
                                       num_shards=N, **KW)
        assert _rel(got, want) < 1e-5

    def test_forms_agree_sharded(self):
        times, counts, _, _, idx = _problem(K=257, P=5)
        plans = indices_to_plans(idx, 257)
        d = scoring.score_plans(times, counts, plans, backend="cuda",
                                num_shards=4, device="cpu", **KW)
        i = scoring.score_plan_indices(times, counts, idx, backend="torch",
                                       num_shards=4, device="cpu", **KW)
        np.testing.assert_allclose(d, i, rtol=1e-5, atol=1e-7)

    @pytest.mark.parametrize("form", ["dense", "index"])
    def test_stats_executors_agree(self, form):
        """emulate and the per-device executor run the same block math:
        on ``[cpu] * N`` they agree bit for bit."""
        times, counts, _, _, idx = _problem(K=64, P=4)
        cc = counts - counts.mean()
        plans = indices_to_plans(idx, 64) if form == "dense" else idx
        for N in (1, 3):
            a = shard.plan_stats_sharded(times, cc, plans, form, N,
                                         executor="shard_map",
                                         devices=[CPU] * N, device="cpu")
            b = shard.plan_stats_sharded(times, cc, plans, form, N,
                                         executor="emulate", device="cpu")
            np.testing.assert_array_equal(a, b)

    def test_empty_plan_scores_zero_time(self):
        """A plan that selects nothing in some blocks takes its max from
        the others; one that selects nothing at all scores round time 0,
        as the single lane does."""
        times, counts, _, _, _ = _problem(K=40)
        plans = np.zeros((3, 40), bool)
        plans[1, 2] = plans[1, 37] = True  # blocks 0 and 3 of 4
        plans[2, 30] = True
        for N in (2, 4):
            got = scoring.score_plans(times, counts, plans, backend="cuda",
                                      num_shards=N, device="cpu", **KW)
            want = scoring.score_plans(times, counts, plans,
                                       backend="numpy", **KW)
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)

    def test_shard_sizes_follow_reference(self):
        for K, N in ((103, 8), (10_000, 4), (262_144, 8), (9, 8)):
            assert shard.shard_sizes(K, N) == ref_shard.shard_sizes(K, N)


# ---- shard-aware auto dispatch and the default backend -------------------


class TestResolveBackendShardAware:
    def test_single_lane_pins(self):
        assert scoring.resolve_backend("auto", 100) == "numpy"
        assert scoring.resolve_backend(
            "auto", scoring.AUTO_NUMPY_MAX_DENSE + 1) == "torch"
        assert scoring.resolve_backend(
            "auto", scoring.AUTO_NUMPY_MAX_INDEX, form="index") == "numpy"

    def test_sharded_fleet_stays_on_torch(self):
        n = 1 << 19
        assert scoring.resolve_backend("auto", n, form="index") == "numpy"
        assert scoring.resolve_backend("auto", n, form="index",
                                       num_shards=8) == "torch"

    def test_tiny_sharded_problem_still_numpy(self):
        assert scoring.MIN_SHARD_ELEMENTS == ref_scoring.MIN_SHARD_ELEMENTS
        n = 8 * scoring.MIN_SHARD_ELEMENTS
        assert scoring.resolve_backend("auto", n, form="index",
                                       num_shards=8) == "numpy"
        assert scoring.resolve_backend("auto", n + 8, form="index",
                                       num_shards=8) == "torch"

    @pytest.mark.parametrize("backend", ["numpy", "cuda"])
    def test_explicit_backend_wins(self, backend):
        assert scoring.resolve_backend(backend, 1 << 22,
                                       num_shards=8) == backend

    def test_auto_dispatch_and_default_backend(self):
        """The reference's tests/test_scoring.py pins, in the port's
        backend names."""
        assert scoring.resolve_backend("auto", 100) == "numpy"
        assert scoring.resolve_backend("auto", 10**7) == "torch"
        scoring.set_default_backend("torch")
        try:
            assert scoring.get_default_backend() == "torch"
            assert scoring.resolve_backend(None, 100) == "torch"
        finally:
            scoring.set_default_backend("auto")
        with pytest.raises(ValueError):
            scoring.resolve_backend("jax", 1)
        with pytest.raises(ValueError):
            scoring.set_default_backend("pallas")

    def test_none_is_the_process_default_in_scoring(self):
        times, counts, _, _, idx = _problem()
        plans = indices_to_plans(idx, times.shape[0])
        want = scoring.score_plans(times, counts, plans, backend="numpy",
                                   **KW)
        assert scoring.get_default_backend() == "auto"
        np.testing.assert_array_equal(
            scoring.score_plans(times, counts, plans, **KW), want)
        scoring.set_default_backend("torch")
        try:
            got = scoring.score_plans(times, counts, plans, device="cpu",
                                      **KW)
            got_i = scoring.score_plan_indices(times, counts, idx,
                                               device="cpu", **KW)
        finally:
            scoring.set_default_backend("auto")
        assert not np.array_equal(got, want)  # f32, not the numpy path
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got_i, want, rtol=1e-5, atol=1e-6)

    def test_default_backend_is_per_thread(self):
        import threading

        seen = []
        scoring.set_default_backend("numpy")
        try:
            t = threading.Thread(
                target=lambda: seen.append(scoring.get_default_backend()))
            t.start()
            t.join()
            assert scoring.get_default_backend() == "numpy"
        finally:
            scoring.set_default_backend("auto")
        assert seen == ["auto"]


# ---- sharded plan ops: validity contracts --------------------------------


def _valid_rows(out, avail, n_sel):
    for row in out:
        assert len(set(row.tolist())) == n_sel
        assert avail[row].all()


class TestShardedPlanOps:
    @pytest.mark.parametrize("N", [1, 2, 8])
    def test_random_indices_valid(self, N):
        _, _, avail, n_sel, _ = _problem()
        out = shard.random_plan_indices_sharded(
            np.random.default_rng(1), avail, n_sel, 7, N, device="cpu")
        assert out.shape == (7, n_sel) and out.dtype == np.int32
        _valid_rows(out, avail, n_sel)

    @pytest.mark.parametrize("N", [1, 2, 8])
    def test_repair_preserves_valid_selections(self, N):
        rng = np.random.default_rng(2)
        _, _, avail, n_sel, _ = _problem()
        K = avail.shape[0]
        plans = np.zeros((5, K), bool)
        for i in range(5):
            plans[i, rng.choice(K, n_sel + 3, replace=False)] = True
        out = shard.repair_plans_sharded(rng, plans, avail, n_sel, N,
                                         device="cpu")
        for i in range(5):
            chosen = set(out[i].tolist())
            assert len(chosen) == n_sel and avail[out[i]].all()
            valid = set(np.flatnonzero(plans[i] & avail).tolist())
            # valid selections outrank noise: they survive up to n_sel
            assert len(chosen & valid) >= min(len(valid), n_sel)

    @pytest.mark.parametrize("N", [1, 2, 8])
    def test_gumbel_topk_valid(self, N):
        rng = np.random.default_rng(3)
        _, _, avail, n_sel, _ = _problem()
        logits = rng.normal(size=(6, avail.shape[0])).astype(np.float32)
        out = shard.gumbel_topk_indices_sharded(rng, logits, avail, n_sel, N,
                                                device="cpu")
        _valid_rows(out, avail, n_sel)

    def test_same_seed_same_draw_and_rng_use(self):
        """One ``rng`` draw a call, as the reference; the draw is a
        function of that draw and N."""
        _, _, avail, n_sel, _ = _problem()
        r1, r2 = np.random.default_rng(4), np.random.default_rng(4)
        a = shard.random_plan_indices_sharded(r1, avail, n_sel, 5, 4,
                                              device="cpu")
        b = shard.random_plan_indices_sharded(r2, avail, n_sel, 5, 4,
                                              device="cpu")
        np.testing.assert_array_equal(np.sort(a, 1), np.sort(b, 1))
        ref = np.random.default_rng(4)
        ref_shard.random_plan_indices_sharded(ref, avail, n_sel, 5, 4)
        assert r1.bit_generator.state == ref.bit_generator.state

    def test_row_chunks_bound_the_draw(self, monkeypatch):
        """Rows are drawn in chunks of at most ``MAX_DRAW_ELEMENTS`` keys;
        chunked draws stay valid."""
        _, _, avail, n_sel, _ = _problem()
        monkeypatch.setattr(shard, "MAX_DRAW_ELEMENTS", 2 * 13)
        out = shard.random_plan_indices_sharded(
            np.random.default_rng(5), avail, n_sel, 9, 8, device="cpu")
        _valid_rows(out, avail, n_sel)

    def test_executors_agree(self):
        """The per-device executor on ``[cpu] * N`` draws what emulate
        draws (the same generators, seeded by (seed, shard id))."""
        _, _, avail, n_sel, _ = _problem()
        a = shard.random_plan_indices_sharded(
            np.random.default_rng(6), avail, n_sel, 6, 4,
            executor="shard_map", devices=[CPU] * 4, device="cpu")
        b = shard.random_plan_indices_sharded(
            np.random.default_rng(6), avail, n_sel, 6, 4,
            executor="emulate", device="cpu")
        np.testing.assert_array_equal(a, b)

    def test_too_few_available_raises(self):
        avail = np.zeros(20, bool)
        avail[:3] = True
        with pytest.raises(ValueError, match="need 4 available"):
            shard.random_plan_indices_sharded(np.random.default_rng(0),
                                              avail, 4, 2, 2, device="cpu")

    def test_resolve_num_shards(self, monkeypatch):
        assert shard.resolve_num_shards(None) == 1
        assert shard.resolve_num_shards(3) == 3
        assert shard.resolve_num_shards(8, fleet_size=5) == 5
        assert shard.resolve_num_shards("auto") >= 1
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
        assert shard.resolve_num_shards("auto") == 1
        assert shard.resolve_num_shards(0) == 1
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
        assert shard.resolve_num_shards("auto") == 4
        assert shard.resolve_num_shards("auto", fleet_size=3) == 3
        with pytest.raises(ValueError):
            shard.resolve_num_shards(-2)

    def test_executor_resolution(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        assert shard._resolve_executor("auto", 2, "cuda") == "shard_map"
        assert shard._resolve_executor("auto", 4, "cuda") == "emulate"
        assert shard._resolve_executor("auto", 2, "cpu") == "emulate"
        assert shard._resolve_executor("auto", 2, "cpu",
                                       devices=[CPU] * 2) == "shard_map"
        assert shard.fleet_devices(2) == [torch.device("cuda", 0),
                                          torch.device("cuda", 1)]
        with pytest.raises(ValueError, match="exceeds"):
            shard.fleet_devices(3)
        with pytest.raises(ValueError):
            shard._resolve_executor("pmap", 2)
        with pytest.raises(ValueError, match="2 devices for 3 shards"):
            shard.block_devices(3, "shard_map", "cpu", [CPU] * 2)


# ---- fused searches: sharded on [cpu] * N, and the fallback -------------


def _search_problem(seed=0, K=150, n_sel=10):
    pool = RefDevicePool.heterogeneous(K, 2, seed=seed)
    cm = RefCostModel(pool, alpha=4.0, beta=0.25)
    cm.calibrate([5.0, 5.0], n_sel=n_sel)
    rng = np.random.default_rng(seed + 1000)
    counts = rng.integers(0, 8, K).astype(np.float64)
    avail = np.ones(K, bool)
    avail[rng.choice(K, K // 5, replace=False)] = False
    times = pool.expected_times(0, 5.0).astype(np.float32)
    kw = dict(alpha=cm.alpha, beta=cm.beta, time_scale=cm.time_scale,
              fairness_scale=cm.fairness_scale,
              delta_fairness=cm.delta_fairness)
    return times, counts, avail, n_sel, kw


def _same_plan_or_tie(ref_plan, port_plan, times, counts, kw):
    if np.array_equal(ref_plan, port_plan):
        return
    costs = scoring.score_plans(times, counts, np.stack([ref_plan, port_plan]),
                                backend="numpy", **kw)
    assert abs(costs[0] - costs[1]) <= 1e-6, costs


class TestSearchShards:
    def test_usable_shards_fallback_rules(self, monkeypatch):
        f = search._usable_search_shards
        monkeypatch.setattr(shard, "shard_capacity", lambda: 4)
        assert f(1, 32) == 1
        assert f(4, 32, device="cuda") == 4
        assert f(4, 30, device="cuda") == 1          # rows do not split
        assert f(4, 32, pairs=True, device="cuda") == 4
        assert f(4, 12, pairs=True, device="cuda") == 1  # 3 rows a block
        assert f(8, 32, device="cuda") == 1          # too few cards
        assert f(4, 32, device="cpu") == 1           # not a card
        assert f(4, 32, device="cpu", devices=[CPU] * 4) == 4
        monkeypatch.setattr(shard, "shard_capacity", lambda: 0)
        assert f(2, 32, device="cuda") == 1

    def test_fallback_is_logged_and_counted(self, caplog):
        before = search.fallbacks
        with caplog.at_level(logging.DEBUG, logger=search.logger.name):
            assert search._usable_search_shards(4, 30, device="cpu") == 1
        assert search.fallbacks == before + 1
        assert "falling back to single lane" in caplog.text
        search._usable_search_shards(1, 30)
        assert search.fallbacks == before + 1

    @pytest.mark.parametrize("greedy_seed", [True, False])
    @pytest.mark.parametrize("N", [2, 4])
    def test_sa_sharded_matches_single_lane_and_reference(self, N,
                                                          greedy_seed):
        times, counts, avail, n_sel, kw = _search_problem(N)
        knobs = dict(steps=40, chains=8, t0=1.0, cooling=0.97,
                     greedy_seed=greedy_seed)
        one = search.sa_search(np.random.default_rng(N), times, counts,
                               avail, n_sel, **kw, **knobs, device="cpu")
        got = search.sa_search(np.random.default_rng(N), times, counts,
                               avail, n_sel, **kw, **knobs, device="cpu",
                               num_shards=N, devices=[CPU] * N)
        np.testing.assert_array_equal(got, one)
        validate_plan(got, avail, n_sel)
        ref = ref_search.sa_search(np.random.default_rng(N), times, counts,
                                   avail, n_sel, **kw, **knobs)
        _same_plan_or_tie(ref, got, times, counts, kw)

    @pytest.mark.parametrize("greedy_seed", [True, False])
    @pytest.mark.parametrize("N", [2, 4])
    def test_ga_sharded_matches_single_lane_and_reference(self, N,
                                                          greedy_seed):
        """Population 16 at N = 4: blocks of 4, two pairs each; the
        per-generation gather keeps selection and elitism global."""
        times, counts, avail, n_sel, kw = _search_problem(N + 10)
        knobs = dict(population=16, generations=6, mutation_rate=0.3,
                     greedy_seed=greedy_seed)
        one = search.ga_search(np.random.default_rng(N), times, counts,
                               avail, n_sel, **kw, **knobs, device="cpu")
        got = search.ga_search(np.random.default_rng(N), times, counts,
                               avail, n_sel, **kw, **knobs, device="cpu",
                               num_shards=N, devices=[CPU] * N)
        np.testing.assert_array_equal(got, one)
        validate_plan(got, avail, n_sel)
        ref = ref_search.ga_search(np.random.default_rng(N), times, counts,
                                   avail, n_sel, **kw, **knobs)
        _same_plan_or_tie(ref, got, times, counts, kw)

    def test_ga_children_block_tiles_the_generation(self):
        """The blocks' children, in order, are the single lane's."""
        g = torch.Generator().manual_seed(0)
        P, S, K = 12, 5, 40
        pop = torch.stack([torch.randperm(K, generator=g)[:S]
                           for _ in range(P)])
        cost = torch.rand(P, generator=g)
        ta, tb = (torch.randint(0, P, (P,), generator=g) for _ in range(2))
        cu = torch.rand(P // 2, S, generator=g)
        mu = torch.rand(P, generator=g)
        mpos = torch.randint(0, S, (P,), generator=g)
        mcand = torch.randint(0, K, (P,), generator=g)
        whole = search._ga_children_block(pop, cost, ta, tb, cu, mu, mpos,
                                          mcand, 0, P, S, 0.5)
        for Pb in (2, 4, 6):
            parts = [search._ga_children_block(
                pop, cost, ta, tb, cu[o // 2:(o + Pb) // 2], mu[o:o + Pb],
                mpos[o:o + Pb], mcand[o:o + Pb], o, Pb, S, 0.5)
                for o in range(0, P, Pb)]
            torch.testing.assert_close(torch.cat(parts), whole, rtol=0,
                                       atol=0)

    def _bods_inputs(self, K=120, n_sel=8, seed=0):
        pool = DevicePool.heterogeneous(K, 2, seed=seed)
        cm = CostModel(pool, alpha=4.0, beta=0.25, device="cpu")
        cm.calibrate([5.0, 5.0], n_sel=n_sel)
        rng = np.random.default_rng(seed + 7)
        counts = rng.integers(0, 8, K).astype(np.float64)
        avail = np.ones(K, bool)
        avail[rng.choice(K, K // 5, replace=False)] = False
        L = 16
        F = np.abs(rng.normal(size=(L, 6))).astype(np.float32) * 0.3
        valid = (rng.random(L) < 0.6).astype(np.float32)
        y = rng.normal(5.0, 1.0, L).astype(np.float32) * valid
        est = (y + rng.normal(size=L) * 0.1).astype(np.float32) * valid
        base = np.zeros(K, bool)
        base[np.flatnonzero(avail)[:n_sel]] = True
        kw = dict(F=F, y=y, est=est, valid=valid, base_plan=base,
                  alpha=cm.alpha, beta=cm.beta, time_scale=cm.time_scale,
                  fairness_scale=cm.fairness_scale,
                  delta_fairness=cm.delta_fairness, num_candidates=32,
                  n_mut=8, local_search=True, gp_noise=0.25)
        times = pool.expected_times(0, 5.0).astype(np.float32)
        return (times, counts, avail, pool.mu, n_sel), kw

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_bods_candidates_and_decision_invariant_to_n(self, seed,
                                                         monkeypatch):
        """The candidate block at N = 4 (blocks of 8 on ``[cpu] * 4``) is
        N = 1's bit for bit, and so is the decision."""
        args, kw = self._bods_inputs(seed=seed)
        blocks = {1: [], 4: []}
        orig = search.bods_candidates

        def keep(n):
            def wrapped(*a, **k):
                out = orig(*a, **k)
                blocks[n].append(out)
                return out
            return wrapped

        outs = {}
        for n in (1, 4):
            monkeypatch.setattr(search, "bods_candidates", keep(n))
            extra = {} if n == 1 else dict(num_shards=4, devices=[CPU] * 4)
            outs[n] = search.bods_acquire(np.random.default_rng(seed), *args,
                                          device="cpu", **kw, **extra)
        assert len(blocks[1]) == 1 and len(blocks[4]) == 4
        assert [b.shape[0] for b in blocks[4]] == [8] * 4
        torch.testing.assert_close(torch.cat(blocks[4]), blocks[1][0],
                                   rtol=0, atol=0)
        np.testing.assert_array_equal(outs[4][0], outs[1][0])
        assert outs[4][1] == outs[1][1]
        validate_plan(outs[1][0], args[2], args[4])

    def test_bods_launches_stats_once_per_block(self, monkeypatch):
        """Featurization reaches the plan-scoring statistics once per
        block per decision."""
        from repro_torch.kernels import ops

        args, kw = self._bods_inputs()
        calls = []
        orig = ops.sched_plan_stats

        def counted(times, weights, plans, impl="ref"):
            calls.append(tuple(plans.shape))
            return orig(times, weights, plans, impl=impl)

        monkeypatch.setattr(ops, "sched_plan_stats", counted)
        search.bods_acquire(np.random.default_rng(0), *args, device="cpu",
                            **kw, num_shards=4, devices=[CPU] * 4)
        assert calls == [(8, 120)] * 4

    def test_hash_draws(self):
        """``hash_bits`` is a pure function of (seed, stream, id, element),
        equal to its Python-integer twin; ``hash_uniform`` lies in (0, 1)
        and is near uniform."""
        ids = torch.tensor([0, 5, 2**20 + 3], dtype=torch.int64)
        bits = search.hash_bits(12345, 3, ids, 7)
        assert bits.dtype == torch.int64
        assert int(bits.min()) >= 0 and int(bits.max()) < 2**32
        key = search._mix32_int(search._mix32_int(12345)
                                ^ ((3 * search._GOLD) & search._M32))
        for r, i in enumerate(ids.tolist()):
            row = search._mix32_int(i * search._GOLD + key)
            for k in range(7):
                assert int(bits[r, k]) == search._mix32_int(
                    row + k * search._GOLD)
        np.testing.assert_array_equal(
            search.hash_bits(12345, 3, ids[1:2], 7), bits[1:2])
        assert not torch.equal(search.hash_bits(12346, 3, ids, 7), bits)
        assert not torch.equal(search.hash_bits(12345, 4, ids, 7), bits)
        u = search.hash_uniform(7, 1, torch.arange(64), 512)
        assert u.dtype == torch.float32
        assert float(u.min()) > 0.0 and float(u.max()) < 1.0
        assert abs(float(u.mean()) - 0.5) < 0.01
        assert abs(float(u.var()) - 1 / 12) < 0.005

    def _scenario(self, K=96, seed=0):
        pool = DevicePool.heterogeneous(K, 2, seed=seed)
        rng = np.random.default_rng(seed + 7)
        counts = rng.integers(0, 8, K).astype(np.float64)
        avail = np.ones(K, bool)
        avail[rng.choice(K, K // 5, replace=False)] = False
        times = pool.expected_times(0, 5.0)

        def ctx():
            return SchedulingContext(
                job=0, round_idx=0, tau=5.0, n_sel=8,
                available=avail.copy(), counts=counts.copy(),
                expected_times=times)

        return pool, ctx

    @pytest.mark.parametrize("name", ["sa", "genetic", "bods"])
    def test_scheduler_decisions_unchanged_by_num_shards(self, name):
        """On a host without enough cards the searches fall back to the
        single lane: same plans, no crash."""
        plans = {}
        before = search.fallbacks
        for n_sh in (1, 4):
            pool, ctx = self._scenario()
            cm = CostModel(pool, alpha=4.0, beta=0.25, num_shards=n_sh,
                           device="cpu")
            cm.calibrate([5.0, 5.0], n_sel=8)
            sched = get_scheduler(name, cost_model=cm, seed=0)
            plans[n_sh] = [sched.schedule(ctx()) for _ in range(3)]
        for a, b in zip(plans[1], plans[4]):
            np.testing.assert_array_equal(a, b)
        assert search.fallbacks == before + 3


# ---- the spec, the CLI and the cost model --------------------------------


def _tiny_spec(**overrides):
    from repro_torch.experiment.spec import JobSpec, PoolSpec

    spec = ExperimentSpec(
        jobs=(JobSpec(name="j0", target_metric=0.75, max_rounds=10),),
        pool=PoolSpec(num_devices=30, seed=3), scheduler="random",
        runtime="synthetic", n_sel=4)
    return spec.replace(**overrides) if overrides else spec


def _record_dict(r):
    import dataclasses

    d = dataclasses.asdict(r)
    for key in ("device_ids", "dropped", "corrupt_ids", "failed_ids"):
        d[key] = np.asarray(d[key]).astype(int).tolist()
    return d


class TestSpecPlumbing:
    def test_num_shards_json_round_trip(self):
        spec = _tiny_spec(fleet={"num_shards": 2})
        back = ExperimentSpec.from_dict(json.loads(spec.to_json()))
        assert back.fleet.num_shards == 2
        assert back.effective_num_shards() == 2
        assert back.build(device="cpu").engine.cost_model.num_shards == 2

    def test_auto_resolves_to_device_count(self, monkeypatch):
        spec = _tiny_spec(fleet={"num_shards": "auto"})
        assert spec.effective_num_shards() == min(
            max(torch.cuda.device_count(), 1), spec.effective_num_devices())
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
        assert spec.effective_num_shards() == 1
        assert _tiny_spec(fleet={"num_shards": 0}).effective_num_shards() == 1
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 64)
        assert spec.effective_num_shards() == 30  # capped at the fleet

    def test_cost_spec_plumbs_num_shards(self):
        from repro_torch.experiment.spec import CostSpec

        pool = DevicePool.heterogeneous(16, 2, seed=0)
        cm = CostSpec(calibrate=False).build(pool, [5.0, 5.0], 4,
                                             num_shards=3, device="cpu")
        assert cm.num_shards == 3

    def test_cost_model_scores_through_the_shards(self, monkeypatch):
        """``cost_batch``/``cost_indices`` pass the shard count on."""
        seen = []
        orig = shard.plan_stats_sharded

        def spy(*a, **k):
            seen.append(a[4])
            return orig(*a, **k)

        monkeypatch.setattr(shard, "plan_stats_sharded", spy)
        times, counts, _, _, idx = _problem()
        pool = DevicePool.heterogeneous(103, 1, seed=0)
        cm = CostModel(pool, scoring_backend="cuda", device="cpu",
                       num_shards=3)
        plans = indices_to_plans(idx, 103)
        np.testing.assert_allclose(
            cm.cost_batch(times, counts, plans),
            cm.cost_indices(times, counts, idx), rtol=1e-5, atol=1e-7)
        assert seen == [3, 3]

    def test_cli_dotted_set_key(self):
        from repro_torch.experiment.cli import _parse_kv

        out = _parse_kv(["fleet.num_shards=4", "fleet.n_sel=8",
                         "scheduler=sa"])
        assert out == {"fleet": {"num_shards": 4, "n_sel": 8},
                       "scheduler": "sa"}
        assert _parse_kv(["fleet.num_shards=auto"]) == {
            "fleet": {"num_shards": "auto"}}

    def test_cli_dotted_collision_rejected(self):
        from repro_torch.experiment.cli import _parse_kv

        with pytest.raises(SystemExit):
            _parse_kv(["fleet=3", "fleet.num_shards=4"])

    def test_cli_runs_sharded_preset(self, tmp_path):
        from repro_torch.experiment import cli

        spec, out = tmp_path / "s.json", tmp_path / "r.json"
        cli.main(["preset", "quickstart", "--arg", "scheduler=genetic",
                  "--arg", "max_rounds=2", "--set", "search_backend=host",
                  "--set", "scoring_backend=torch", "--set",
                  "fleet.num_shards=2", "--out", str(spec)])
        assert json.loads(spec.read_text())["fleet"]["num_shards"] == 2
        cli.main(["run", str(spec), "--device", "cpu", "--out", str(out)])
        d = json.loads(out.read_text())
        assert d["spec"]["fleet"]["num_shards"] == 2
        assert len(d["records"]) == 6

    @pytest.mark.parametrize("scheduler", ["genetic", "sa"])
    def test_reference_spec_with_shards_identical(self, scheduler):
        """A spec the reference wrote with ``fleet.num_shards=2`` runs in
        the port to the reference's records (the auto backend: each
        shard's problem is below MIN_SHARD_ELEMENTS, so numpy scores)."""
        ref = ref_presets.get_preset("quickstart", scheduler=scheduler,
                                     max_rounds=6).replace(
            search_backend="host", fleet={"num_shards": 2})
        a = ref.run().records
        port = ExperimentSpec.from_dict(json.loads(ref.to_json()))
        assert port.effective_num_shards() == 2
        b = port.run(device="cpu").records
        assert len(a) == len(b) > 0
        for ra, rb in zip(a, b):
            assert _record_dict(ra) == _record_dict(rb)

    def test_reference_spec_sharded_scoring_greedy(self):
        """The sharded tensor path end to end: greedy's decisions are
        closed-form, so the records are the reference's sharded jax run's,
        est_cost within the scoring tolerance."""
        ref = ref_presets.get_preset("paper-group-a", scheduler="greedy",
                                     max_rounds=4, num_devices=1000).replace(
            scoring_backend="jax", fleet={"num_shards": 2})
        a = ref.run().records
        port = ExperimentSpec.from_dict(json.loads(ref.to_json()))
        assert port.effective_scoring_backend() == "torch"
        for backend in ("torch", "cuda"):
            b = port.replace(scoring_backend=backend).run(device="cpu")
            assert len(a) == len(b.records) > 0
            for ra, rb in zip(a, b.records):
                da, db = _record_dict(ra), _record_dict(rb)
                assert abs(da.pop("est_cost") - db.pop("est_cost")) <= 1e-5
                assert da == db


# ---- launch bootstrap ----------------------------------------------------


class TestBootstrap:
    def test_single_shard_is_noop(self, monkeypatch):
        from repro_torch.launch import bootstrap

        monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
        assert bootstrap.ensure_host_devices(1) is True
        with pytest.raises(ValueError):
            bootstrap.ensure_host_devices(0)

    def test_shortfall_is_reported(self, monkeypatch, capsys):
        from repro_torch.launch import bootstrap

        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        assert bootstrap.ensure_host_devices(2) is True
        assert bootstrap.ensure_host_devices(4) is False
        assert bootstrap.main(["--shards", "4"]) == 1
        assert "short" in capsys.readouterr().out
        assert bootstrap.main(["--shards", "2"]) == 0

    def test_no_reexec_and_no_xla_flags(self, monkeypatch):
        import os

        from repro_torch.launch import bootstrap

        monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
        monkeypatch.setattr(os, "execve", lambda *a: pytest.fail("re-exec"))
        env = dict(os.environ)
        assert bootstrap.ensure_host_devices(8) is False
        assert dict(os.environ) == env
