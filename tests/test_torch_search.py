"""The port's fused searches (``repro_torch.core.search``) and optimizers
vs the reference's, on the same numpy inputs, on the CPU.

Tolerances, from the reference's own tests (tests/test_search.py):
``plan_costs``/``plan_costs_idx`` and ``featurize_plans`` within 2e-4;
``ei_scores`` (also batched over jobs, against the reference's
``ei_scores_jobs``) within 1e-5 relative and 1e-6 absolute.
SA and GA draw all their noise from the numpy ``rng`` in the reference's
order, so the port must return the reference's plan, or a plan of the same
cost within 1e-6 (an f32 tie). The BODS acquisition is held on an injected
candidate block (its own candidates are ``jax.random`` draws): the same
argmax. One RLDS REINFORCE gradient and one ``adamw`` update within 1e-6.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

import jax  # noqa: E402

from repro.core import search as ref_search  # noqa: E402
from repro.core.cost import CostModel as RefCostModel  # noqa: E402
from repro.core.devices import DevicePool as RefDevicePool  # noqa: E402
from repro.core.schedulers import get_scheduler as ref_get_scheduler  # noqa: E402
from repro.core.schedulers import rlds as ref_rlds  # noqa: E402
from repro.optim import optimizers as ref_opt  # noqa: E402
from repro_torch.core import search  # noqa: E402
from repro_torch.core.cost import CostModel  # noqa: E402
from repro_torch.core.devices import DevicePool  # noqa: E402
from repro_torch.core.plans import random_plans, validate_plan  # noqa: E402
from repro_torch.core.schedulers import get_scheduler  # noqa: E402
from repro_torch.core.schedulers import rlds  # noqa: E402
from repro_torch.core.schedulers.base import SchedulingContext  # noqa: E402
from repro_torch.optim import optimizers as opt  # noqa: E402

COST_TOL = dict(rtol=2e-4, atol=2e-4)
EI_TOL = dict(rtol=1e-5, atol=1e-6)
COEF = (4.0, 0.25, 3.0, 0.09)   # alpha, beta, time_scale, fairness_scale
SEEDS = range(5)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs several test files at once, and
    the timing-sensitive tests of other files must not be starved."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def t32(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def make_ctx(pool, job=0, n_sel=5, occupied=None, counts=None, round_idx=0,
             ctx_cls=SchedulingContext):
    K = pool.num_devices
    avail = np.ones(K, dtype=bool)
    if occupied is not None:
        avail[occupied] = False
    return ctx_cls(job=job, round_idx=round_idx, tau=5.0, n_sel=n_sel,
                   available=avail,
                   counts=counts if counts is not None else np.zeros(K),
                   expected_times=pool.expected_times(job, 5.0))


def scenario(K, seed, n_sel, busy_frac=0.2, pkg="port"):
    Pool, CM = ((DevicePool, CostModel) if pkg == "port"
                else (RefDevicePool, RefCostModel))
    pool = Pool.heterogeneous(K, 2, seed=seed)
    kw = dict(device="cpu") if pkg == "port" else {}
    cm = CM(pool, alpha=4.0, beta=0.25, **kw)
    cm.calibrate([5.0, 5.0], n_sel=n_sel)
    rng = np.random.default_rng(seed + 1000)
    counts = rng.integers(0, 8, K).astype(np.float64)
    occ = rng.choice(K, int(K * busy_frac), replace=False)
    return cm, pool, counts, occ


def cost_problem(seed, K=200, P=24, n_sel=12):
    rng = np.random.default_rng(seed)
    times = rng.uniform(0.5, 80.0, K)
    counts = rng.integers(0, 40, K).astype(np.float64)
    plans = random_plans(rng, np.ones(K, bool), n_sel, P)
    return times, counts, plans


# ---- Formula 2 on the device ----------------------------------------------

@pytest.mark.parametrize("delta", [True, False])
def test_plan_costs_match_reference(delta):
    times, counts, plans = cost_problem(0)
    idx = np.stack([np.flatnonzero(p) for p in plans])
    counts_c = (counts - counts.mean()).astype(np.float32)
    want_d = np.asarray(ref_search.plan_costs(
        jnp.asarray(times, jnp.float32), jnp.asarray(counts_c),
        jnp.asarray(plans), *COEF, delta))
    want_i = np.asarray(ref_search.plan_costs_idx(
        jnp.asarray(times, jnp.float32), jnp.asarray(counts_c),
        jnp.asarray(idx, jnp.int32), *COEF, delta))
    got_d = search.plan_costs(t32(times), t32(counts_c),
                              torch.from_numpy(plans), *COEF, delta)
    got_i = search.plan_costs_idx(t32(times), t32(counts_c),
                                  torch.from_numpy(idx), *COEF, delta)
    np.testing.assert_allclose(got_d.numpy(), want_d, **COST_TOL)
    np.testing.assert_allclose(got_i.numpy(), want_i, **COST_TOL)
    # Same multiset of f64-summed weights: the two forms agree bit for bit.
    np.testing.assert_array_equal(got_d.numpy(), got_i.numpy())


def test_dense_stats_map_empty_plans_to_zero_time():
    """Kernel 2.1 gives -1e30 for an empty plan; the reference's masked
    max gives 0, and so must the port's statistics."""
    times, counts, plans = cost_problem(1, P=4)
    plans[2] = False
    counts_c = t32(counts - counts.mean())
    t, n, wsum = search._dense_stats(t32(times), counts_c,
                                     torch.from_numpy(plans))
    assert t[2].item() == 0.0 and n[2].item() == 0.0 and wsum[2].item() == 0.0
    assert torch.all(t[[0, 1, 3]] > 0)


def featurize_problem(seed=0, K=60, P=16, n_sel=6):
    cm, pool, counts, occ = scenario(K, seed, n_sel)
    ctx = make_ctx(pool, n_sel=n_sel, occupied=occ, counts=counts)
    rng = np.random.default_rng(seed + 1)
    plans = random_plans(rng, ctx.available, n_sel, P)
    plans[3] = False  # an empty row: the -1e30 -> 0 mapping
    return cm, pool, counts, ctx, plans


@pytest.mark.parametrize("delta", [True, False])
def test_featurize_plans_match_reference(delta):
    cm, pool, counts, ctx, plans = featurize_problem()
    counts_c = (counts - counts.mean()).astype(np.float32)
    args = (cm.time_scale, cm.fairness_scale, ctx.n_sel, delta)
    want = ref_search.featurize_plans(
        jnp.asarray(ctx.expected_times, jnp.float32), jnp.asarray(counts_c),
        jnp.asarray(counts == 0), jnp.asarray(pool.mu, jnp.float32),
        jnp.asarray(plans), *args)
    got = search.featurize_plans(
        t32(ctx.expected_times), t32(counts_c), torch.from_numpy(counts == 0),
        t32(pool.mu), torch.from_numpy(plans), *args)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **COST_TOL)
    assert got[0][3, 0].item() == 0.0  # empty plan: round time 0


def test_featurize_plans_match_host_bods():
    """The device phi(V) matches the port's host ``_featurize``."""
    cm, pool, counts, ctx, plans = featurize_problem(seed=2)
    sched = get_scheduler("bods", cost_model=cm, seed=0)
    want = sched._featurize(ctx, plans)
    got, _, _ = search.featurize_plans(
        t32(ctx.expected_times), t32(counts - counts.mean()),
        torch.from_numpy(counts == 0), t32(pool.mu), torch.from_numpy(plans),
        cm.time_scale, cm.fairness_scale, ctx.n_sel, cm.delta_fairness)
    np.testing.assert_allclose(got.numpy(), want, **COST_TOL)


# ---- GP and Expected Improvement ------------------------------------------

def gp_problem(seed, fill, M=None, L=256, P=17, d=6):
    rng = np.random.default_rng(seed)
    lead = () if M is None else (M,)
    F = rng.normal(size=lead + (L, d)).astype(np.float32)
    resid = rng.normal(size=lead + (L,)).astype(np.float32)
    valid = (rng.random(lead + (L,)) < fill).astype(np.float32)
    feats = rng.normal(size=lead + (P, d)).astype(np.float32)
    cand = rng.normal(size=lead + (P,)).astype(np.float32)
    return F, resid * valid, valid, feats, cand


@pytest.mark.parametrize("fill", [0.0, 0.06, 0.3, 1.0])
def test_ei_scores_match_reference(fill):
    args = gp_problem(3, fill)
    want = np.asarray(ref_search.ei_scores(*map(jnp.asarray, args),
                                           jnp.float32(0.25)))
    got = search.ei_scores(*map(t32, args), 0.25).numpy()
    np.testing.assert_allclose(got, want, **EI_TOL)
    assert np.argmax(got) == np.argmax(want)


def test_ei_scores_jobs_match_reference_and_per_job():
    args = gp_problem(4, 0.3, M=3)
    want = np.asarray(ref_search.ei_scores_jobs(*args, 0.25))
    got = search.ei_scores(*map(t32, args), 0.25).numpy()
    assert got.shape == want.shape == (3, 17)
    np.testing.assert_allclose(got, want, **EI_TOL)
    for m in range(3):
        one = search.ei_scores(*(t32(a[m]) for a in args), 0.25).numpy()
        np.testing.assert_allclose(got[m], one, **EI_TOL)


# ---- SA and GA: host-drawn noise, the reference's plans -------------------

def search_problem(seed, K=150, n_sel=10):
    cm, pool, counts, occ = scenario(K, seed, n_sel, pkg="ref")
    avail = np.ones(K, bool)
    avail[occ] = False
    times = pool.expected_times(0, 5.0).astype(np.float32)
    kw = dict(alpha=cm.alpha, beta=cm.beta, time_scale=cm.time_scale,
              fairness_scale=cm.fairness_scale,
              delta_fairness=cm.delta_fairness)
    return times, counts, avail, n_sel, kw


def same_plan_or_tie(ref_plan, port_plan, times, counts, kw):
    if np.array_equal(ref_plan, port_plan):
        return
    from repro_torch.core import scoring

    costs = scoring.score_plans(times, counts, np.stack([ref_plan, port_plan]),
                                backend="numpy", **kw)
    assert abs(costs[0] - costs[1]) <= 1e-6, costs


@pytest.mark.parametrize("greedy_seed", [True, False])
@pytest.mark.parametrize("seed", SEEDS)
def test_sa_search_matches_reference(seed, greedy_seed):
    times, counts, avail, n_sel, kw = search_problem(seed)
    knobs = dict(steps=60, chains=8, t0=1.0, cooling=0.97,
                 greedy_seed=greedy_seed)
    ref_plan = ref_search.sa_search(np.random.default_rng(seed), times,
                                    counts, avail, n_sel, **kw, **knobs)
    rng = np.random.default_rng(seed)
    plan = search.sa_search(rng, times, counts, avail, n_sel, **kw, **knobs,
                            device="cpu")
    validate_plan(plan, avail, n_sel)
    same_plan_or_tie(ref_plan, plan, times, counts, kw)
    # Both consumed the same host noise.
    ref_rng = np.random.default_rng(seed)
    ref_search.sa_search(ref_rng, times, counts, avail, n_sel, **kw, **knobs)
    assert rng.bit_generator.state == ref_rng.bit_generator.state


@pytest.mark.parametrize("greedy_seed", [True, False])
@pytest.mark.parametrize("seed", SEEDS)
def test_ga_search_matches_reference(seed, greedy_seed):
    """Without the greedy seed the best plan is the GA's own (selection,
    crossover, mutation and elitism all decide it)."""
    times, counts, avail, n_sel, kw = search_problem(seed)
    knobs = dict(population=15, generations=8, mutation_rate=0.3,
                 greedy_seed=greedy_seed)
    ref_plan = ref_search.ga_search(np.random.default_rng(seed), times,
                                    counts, avail, n_sel, **kw, **knobs)
    plan = search.ga_search(np.random.default_rng(seed), times, counts,
                            avail, n_sel, **kw, **knobs, device="cpu")
    validate_plan(plan, avail, n_sel)
    same_plan_or_tie(ref_plan, plan, times, counts, kw)


def test_sa_metropolis_exponent_clamped():
    """t0 ~ 0 on uncalibrated (large) costs: the clamped exponent keeps
    every step finite, and the decision is the reference's."""
    pool = DevicePool.heterogeneous(30, 1, seed=0)
    times = pool.expected_times(0, 5.0).astype(np.float32)
    kw = dict(alpha=100.0, beta=50.0, time_scale=1.0, fairness_scale=1.0,
              delta_fairness=True, steps=50, chains=4, t0=1e-12,
              cooling=0.97)
    avail = np.ones(30, bool)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        plan = search.sa_search(np.random.default_rng(0), times,
                                np.zeros(30), avail, 5, **kw, device="cpu")
    validate_plan(plan, avail, 5)
    ref_plan = ref_search.sa_search(np.random.default_rng(0), times,
                                    np.zeros(30), avail, 5, **kw)
    np.testing.assert_array_equal(plan, ref_plan)
    temps = search._temperatures(1e-12, 0.97, 50)
    assert temps.dtype == np.float32 and temps.min() == np.float32(1e-9)


def test_sa_no_free_device_completes():
    """available == n_sel: every swap masks out, the plan stays valid."""
    pool = DevicePool.heterogeneous(20, 1, seed=0)
    cm = CostModel(pool, device="cpu")
    cm.calibrate([5.0], n_sel=3)
    sched = get_scheduler("sa", cost_model=cm, seed=0)
    ctx = make_ctx(pool, n_sel=3, occupied=np.arange(3, 20))
    validate_plan(sched.schedule(ctx), ctx.available, 3)


# ---- fused plan invariants and errors -------------------------------------

@pytest.mark.parametrize("name", ["sa", "genetic", "bods"])
def test_fused_plan_invariants(name):
    """The fused searchers return exactly n_sel available devices, always,
    across evolving occupancy/counts."""
    pool = DevicePool.heterogeneous(40, 2, seed=1)
    cm = CostModel(pool, device="cpu")
    cm.calibrate([5.0, 5.0], n_sel=4)
    sched = get_scheduler(name, cost_model=cm, seed=0,
                          search_backend="fused")
    rng = np.random.default_rng(0)
    counts = np.zeros(40)
    for r in range(6):
        occ = rng.choice(40, rng.integers(0, 20), replace=False)
        ctx = make_ctx(pool, n_sel=4, occupied=occ, counts=counts,
                       round_idx=r)
        plan = sched.schedule(ctx)
        validate_plan(plan, ctx.available, 4)
        assert np.isfinite(sched.last_estimated_cost)
        sched.observe(ctx, plan, float(rng.random()))
        counts += plan


@pytest.mark.parametrize("name", ["sa", "genetic", "bods"])
def test_fused_raises_when_pool_too_small(name):
    pool = DevicePool.heterogeneous(10, 1, seed=0)
    cm = CostModel(pool, device="cpu")
    sched = get_scheduler(name, cost_model=cm, seed=0,
                          search_backend="fused")
    ctx = make_ctx(pool, n_sel=5, occupied=np.arange(6))
    with pytest.raises(ValueError, match="need 5 available devices"):
        sched.schedule(ctx)


def test_repair_plans_torch_contract():
    """The device twin of ``repair_plans_jax``: feasible, keeps valid
    selections, idempotent on valid plans."""
    rng = np.random.default_rng(3)
    gen = torch.Generator().manual_seed(0)
    for _ in range(10):
        K, n_sel = 40, 6
        avail = rng.random(K) < 0.6
        if avail.sum() < n_sel:
            avail[rng.choice(K, n_sel, replace=False)] = True
        raw = rng.random((8, K)) < 0.3
        out = search.repair_plans_torch(gen, torch.from_numpy(raw),
                                        torch.from_numpy(avail), n_sel).numpy()
        for r_raw, r in zip(raw, out):
            validate_plan(r, avail, n_sel)
            keep = r_raw & avail
            if keep.sum() <= n_sel:
                assert np.all(r[keep])
            else:
                assert np.all(keep[r])
        valid = random_plans(rng, avail, n_sel, 4)
        fixed = search.repair_plans_torch(gen, torch.from_numpy(valid),
                                          torch.from_numpy(avail), n_sel)
        np.testing.assert_array_equal(fixed.numpy(), valid)


# ---- the BODS acquisition --------------------------------------------------

def bods_inputs(seed, K=120, P=48, n_sel=8):
    cm, pool, counts, occ = scenario(K, seed, n_sel)
    ctx = make_ctx(pool, n_sel=n_sel, occupied=occ, counts=counts)
    rng = np.random.default_rng(seed + 7)
    cands = random_plans(rng, ctx.available, n_sel, P)
    F, resid, valid, _, _ = gp_problem(seed, 0.2, P=P)
    F = np.abs(F) * 0.3
    y = rng.normal(5.0, 1.0, valid.shape).astype(np.float32) * valid
    est = (y + resid * 0.1).astype(np.float32) * valid
    return cm, pool, counts, ctx, cands, F, y, est, valid


@pytest.mark.parametrize("seed", SEEDS)
def test_bods_scores_on_injected_block_match_reference(seed):
    """The acquisition's scoring on an injected candidate block picks the
    reference's candidate (its ``featurize_plans`` + ``ei_scores``)."""
    cm, pool, counts, ctx, cands, F, y, est, valid = bods_inputs(seed)
    sd = float(y[valid > 0].std()) + 1e-6
    resid = (y - est) / sd * valid
    counts_c = search._center(counts)
    feats, et, df = ref_search.featurize_plans(
        jnp.asarray(ctx.times32()), jnp.asarray(counts_c),
        jnp.asarray(counts == 0), jnp.asarray(pool.mu, jnp.float32),
        jnp.asarray(cands), cm.time_scale, cm.fairness_scale, ctx.n_sel,
        cm.delta_fairness)
    ref_est = np.float32(cm.alpha) * np.asarray(et) + \
        np.float32(cm.beta) * np.asarray(df)
    want = np.asarray(ref_search.ei_scores(
        jnp.asarray(F), jnp.asarray(resid), jnp.asarray(valid), feats,
        jnp.asarray(ref_est / np.float32(sd)), jnp.float32(0.25)))
    ei, cand_est = search.bods_scores(
        torch.from_numpy(cands), t32(ctx.times32()), t32(counts_c),
        torch.from_numpy(counts == 0), t32(pool.mu), t32(F), t32(resid),
        t32(valid), 1.0 / sd, cm.alpha, cm.beta, cm.time_scale,
        cm.fairness_scale, 0.25, ctx.n_sel, cm.delta_fairness)
    np.testing.assert_allclose(cand_est.numpy(), ref_est, **COST_TOL)
    np.testing.assert_allclose(ei.numpy(), want, rtol=1e-4, atol=1e-5)
    assert int(torch.argmax(ei)) == int(np.argmax(want))


def test_bods_acquire_is_a_function_of_the_seed():
    cm, pool, counts, ctx, _, F, y, est, valid = bods_inputs(0)
    kw = dict(F=F, y=y, est=est, valid=valid, base_plan=None,
              alpha=cm.alpha, beta=cm.beta, time_scale=cm.time_scale,
              fairness_scale=cm.fairness_scale,
              delta_fairness=cm.delta_fairness, num_candidates=32, n_mut=8,
              local_search=True, gp_noise=0.25, device="cpu")
    out = [search.bods_acquire(np.random.default_rng(5), ctx.times32(),
                               counts, ctx.available, pool.mu, ctx.n_sel,
                               **kw) for _ in range(2)]
    np.testing.assert_array_equal(out[0][0], out[1][0])
    assert out[0][1] == out[1][1]
    validate_plan(out[0][0], ctx.available, ctx.n_sel)
    base = out[0][0]
    plan, e = search.bods_acquire(np.random.default_rng(6), ctx.times32(),
                                  counts, ctx.available, pool.mu, ctx.n_sel,
                                  **dict(kw, base_plan=base))
    validate_plan(plan, ctx.available, ctx.n_sel)
    assert np.isfinite(e)


def test_bods_candidates_layout():
    """Rows [0, n_mut) are repaired mutants of the base plan; every row is
    a valid plan; with a flat pool the structured rows stay valid."""
    K, n_sel, P = 64, 5, 16
    avail = torch.ones(K, dtype=torch.bool)
    avail[::3] = False
    base = torch.zeros(K, dtype=torch.bool)
    base[torch.nonzero(avail)[:n_sel, 0]] = True
    mutants = base[None].repeat(4, 1)
    for seed, times in ((1, torch.rand(K)), (2, torch.ones(K))):
        cands = search.bods_candidates(seed, 0, P, times, torch.zeros(K),
                                       avail, mutants, P, n_sel,
                                       use_base=True)
        for row in cands.numpy():
            validate_plan(row, avail.numpy(), n_sel)
        np.testing.assert_array_equal(cands[:4].numpy(),
                                      mutants.numpy())  # valid: idempotent


# ---- optimizers and the RLDS gradient --------------------------------------

def tree_np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def test_adamw_update_matches_reference():
    rng = np.random.default_rng(0)
    params = {"a": rng.normal(size=(6, 8)).astype(np.float32),
              "b": rng.normal(size=8).astype(np.float32)}
    ref_init, ref_update = ref_opt.adamw(0.01, 0.9, 0.999, 1e-8, 0.01)
    init, update = opt.adamw(0.01, 0.9, 0.999, 1e-8, 0.01)
    rs = ref_init(params)
    ps = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    st = init(ps)
    for _ in range(3):
        g = {k: rng.normal(size=v.shape).astype(np.float32)
             for k, v in params.items()}
        ru, rs = ref_update(g, rs, params)
        u, st = update({k: torch.from_numpy(v) for k, v in g.items()}, st,
                       ps)
        for k in params:
            np.testing.assert_allclose(u[k].numpy(), np.asarray(ru[k]),
                                       rtol=0, atol=1e-6)
    assert int(st.step) == int(rs.step) == 3
    m, v = st.inner
    for k in params:
        np.testing.assert_allclose(m[k].numpy(), np.asarray(rs.inner[0][k]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(v[k].numpy(), np.asarray(rs.inner[1][k]),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["sgd", "momentum", "adamw"])
def test_optimizers_converge_on_quadratic(name):
    init, update = {"sgd": opt.sgd(0.1), "momentum": opt.momentum(0.05, 0.9),
                    "adamw": opt.adamw(0.3)}[name]
    params = {"w": torch.tensor([3.0, -2.0, 1.5])}
    st = init(params)
    for _ in range(200):
        grads = {"w": 2.0 * params["w"]}
        upd, st = update(grads, st, params)
        params = {"w": params["w"] + upd["w"]}
    assert float(params["w"].abs().max()) < 0.05


def test_clip_by_global_norm_matches_reference():
    g = {"a": np.full((3,), 4.0, np.float32), "b": np.full((2, 2), -3.0,
                                                          np.float32)}
    ref, ref_n = ref_opt.clip_by_global_norm(g, 1.0)
    got, n = opt.clip_by_global_norm({k: torch.from_numpy(v)
                                      for k, v in g.items()}, 1.0)
    np.testing.assert_allclose(float(n), float(ref_n), rtol=1e-6)
    for k in g:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-6)


def test_reinforce_grads_and_update_match_reference():
    """One REINFORCE gradient (autograd through the K-cell LSTM) and one
    ``policy_optimizer`` update from the reference's ``init_policy``."""
    params = tree_np(ref_rlds.init_policy(jax.random.PRNGKey(3)))
    rng = np.random.default_rng(0)
    N, K = 3, 40
    feats = rng.random((N, K, rlds.NUM_FEATURES)).astype(np.float32)
    plans = (rng.random((N, K)) < 0.2).astype(np.float32)
    avail = (rng.random((N, K)) < 0.9).astype(np.float32)
    adv = rng.normal(size=N).astype(np.float32)
    want = ref_rlds._reinforce_grads(params, *map(jnp.asarray,
                                                  (feats, plans, avail, adv)))
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    got = rlds._reinforce_grads(tp, *map(t32, (feats, plans, avail, adv)))
    for k in params:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-6)
    probs = rlds._probs(tp, t32(feats[0])).numpy()
    np.testing.assert_allclose(
        probs, np.asarray(ref_rlds._probs(params, jnp.asarray(feats[0]))),
        rtol=0, atol=1e-6)
    r_init, r_upd = ref_rlds.policy_optimizer(1e-2)
    p_init, p_upd = rlds.policy_optimizer(1e-2)
    ru, _ = r_upd(want, r_init(params), params)
    pu, _ = p_upd({k: torch.from_numpy(np.array(v)) for k, v in
                   want.items()}, p_init(tp), tp)
    for k in params:
        np.testing.assert_allclose(pu[k].numpy(), np.asarray(ru[k]), rtol=0,
                                   atol=1e-6)


def test_dnn_init_is_the_references_bit_for_bit():
    pool = DevicePool.heterogeneous(30, 1, seed=0)
    ref = ref_get_scheduler("dnn", cost_model=RefCostModel(
        RefDevicePool.heterogeneous(30, 1, seed=0)), seed=4)
    port = get_scheduler("dnn", cost_model=CostModel(pool, device="cpu"),
                         seed=4)
    for k, v in ref.params.items():
        np.testing.assert_array_equal(port.params[k].numpy(), np.asarray(v))
    assert port.rng.bit_generator.state == ref.rng.bit_generator.state
