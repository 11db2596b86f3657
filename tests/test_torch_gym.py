"""The scheduler gym in the port (``repro_torch.gym``) vs the reference
(``repro.gym``) on the CPU, at small sizes.

The reference draws every scenario and every rollout's noise with
``jax.random``; the port draws from a ``torch.Generator``. So these tests
repeat the reference's own key splits (``reset``: one (scenario, env) pair
per environment key; each rollout: six keys from the env key; the trainer:
reset and permutation keys) to get the draws the reference consumes, and
inject them into the port (``convert.env_state_from_reference``, the
rollouts' ``noise=``, ``train_iter``'s ``IterDraws``).

Tolerances: derived scenario arrays 1e-6 relative; each round's
``StepOut`` and the clocks 1e-5 (the port sums the fairness weights in f64,
the reference in f32); counts, round indices, jobs and steps exact; policy
features and costs 1e-5; plans identical except at a near tie of logit plus
Gumbel (1e-5), counted and reported.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.schedulers import rlds as ref_rlds  # noqa: E402
from repro.gym import env as ref_env  # noqa: E402
from repro.gym import scenarios as ref_scen  # noqa: E402
from repro.gym import train as ref_train  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import scoring  # noqa: E402
from repro_torch.core.cost import CostModel  # noqa: E402
from repro_torch.core.devices import DevicePool  # noqa: E402
from repro_torch.core.multijob import MultiJobEngine  # noqa: E402
from repro_torch.core.plans import random_plans  # noqa: E402
from repro_torch.core.schedulers.base import SchedulerBase  # noqa: E402
from repro_torch.core.schedulers.rlds import init_policy  # noqa: E402
from repro_torch.experiment.spec import JobSpec  # noqa: E402
from repro_torch.gym import (CURRICULA, EnvConfig, TrainConfig,  # noqa: E402
                             batch_reset, batch_rollout, default_stages,
                             evaluate, policy_rollout, reset, state_from_pool,
                             step, train_rlds)
from repro_torch.gym import env as genv  # noqa: E402
from repro_torch.gym import train as gtrain  # noqa: E402
from repro_torch.gym.scenarios import ScenarioDraw  # noqa: E402

NEAR_TIE = 1e-5
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def small_cfg(**kw):
    return EnvConfig(**{"num_devices": 24, "num_jobs": 2, "n_sel": 3, **kw})


def host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def t32(x) -> torch.Tensor:
    return torch.as_tensor(np.array(x, np.float32))


# ---- the reference's draws, by its own key splits ------------------------

def ref_env_keys(key, num_envs):
    """``batch_reset``'s per-env keys, each split by ``reset`` into its
    scenario key and the state's key."""
    pairs = jax.vmap(jax.random.split)(jax.random.split(key, num_envs))
    return pairs[:, 0], pairs[:, 1]


def ref_scenario_draw(key, spec, K, M, E):
    k_scen, _ = ref_env_keys(key, E)
    return jax.vmap(lambda k: ref_scen.sample_scenario(k, spec, K, M))(k_scen)


def ref_rollout_noise(states, T, K, deterministic=False):
    """The five (E, T, K) draws each env's rollout makes from its key."""

    def one(k):
        _, k_e, k_f, k_g, k_s, k_d = jax.random.split(k, 6)
        return (jax.random.exponential(k_e, (T, K)),
                jax.random.uniform(k_f, (T, K)),
                (jnp.zeros((T, K)) if deterministic
                 else jax.random.gumbel(k_g, (T, K))),
                jax.random.uniform(k_s, (T, K)),
                jax.random.uniform(k_d, (T, K)))

    return tuple(t32(x) for x in jax.vmap(one)(states.key))


def ref_params(seed=0):
    return ref_rlds.init_policy(jax.random.PRNGKey(seed))


def port_params(params):
    return {k: t32(v) for k, v in params.items()}


def close(got, exp, rtol=1e-5, atol=1e-6, what=""):
    np.testing.assert_allclose(host(got), host(exp), rtol=rtol, atol=atol,
                               err_msg=what)


# ---- scenarios -----------------------------------------------------------

def test_curricula_match_reference():
    assert list(CURRICULA) == list(ref_scen.CURRICULA)
    for name, spec in CURRICULA.items():
        assert (dataclasses.asdict(spec)
                == dataclasses.asdict(ref_scen.CURRICULA[name])), name


@pytest.mark.parametrize("curriculum", ["full", "arrivals", "faults"])
def test_sample_scenario_ranges(curriculum):
    spec = CURRICULA[curriculum]
    g = torch.Generator().manual_seed(0)
    d = genv.sample_scenario(g, spec, 40, 3, 64, CPU)
    assert d.a.shape == (64, 40) and d.data.shape == (64, 40, 3)
    spread = torch.log10(d.a / spec.a_lo)
    assert float(spread.min()) >= 0.0
    assert float(spread.max()) <= spec.hetero_decades[1] + 1e-5
    taus = d.taus
    assert set(torch.unique(taus).tolist()) <= set(
        range(spec.tau_range[0], spec.tau_range[1] + 1))
    if spec.tau_range[0] != spec.tau_range[1]:
        # randint covers both ends
        assert float(taus.min()) == spec.tau_range[0]
        assert float(taus.max()) == spec.tau_range[1]
    assert bool((d.job_start[:, 0] == 0).all())
    assert not bool(torch.isfinite(d.job_end[:, 0]).any())
    if spec.num_domains:
        assert int(d.domain.max()) == spec.num_domains - 1
        assert float(d.domain_rate.max()) <= spec.domain_outage_range[1]
    else:
        assert not bool(d.domain.any()) and not bool(d.domain_rate.any())
    lo, hi = spec.failure_range
    assert bool(((d.failure_rate >= lo) & (d.failure_rate <= hi)).all())


@pytest.mark.parametrize("curriculum,n_sel,M", [
    ("default", 4, 2), ("full", 5, 3), ("faults", 6, 3), ("arrivals", 4, 2),
])
def test_make_scenario_matches_reference(curriculum, n_sel, M):
    """Every derived array of an injected draw within 1e-6 relative;
    ``time_scale`` too, also at an even n_sel and an even job count, where
    ``torch.median`` (the lower middle) would be wrong."""
    K, E = 30, 4
    spec = CURRICULA[curriculum]
    cfg = EnvConfig(num_devices=K, num_jobs=M, n_sel=n_sel)
    key = jax.random.PRNGKey(11)
    ref = ref_env.batch_reset(cfg, spec, key, E)
    draw = convert.env_state_from_reference(
        ref_scenario_draw(key, spec, K, M, E), CPU)
    assert isinstance(draw, ScenarioDraw)
    port = genv.state_from_draw(cfg, spec, draw)
    for f in genv.Scenario._fields:
        exp = host(getattr(ref.scen, f))
        got = host(getattr(port.scen, f))
        assert got.shape == exp.shape, f
        if np.issubdtype(exp.dtype, np.integer):
            np.testing.assert_array_equal(got, exp, err_msg=f)
        else:
            np.testing.assert_allclose(got, exp, rtol=1e-6, err_msg=f)
    # the scenario converted whole gives the same derived arrays
    whole = convert.env_state_from_reference(ref, CPU)
    close(whole.scen.time_scale, port.scen.time_scale, rtol=1e-6, atol=0)
    if n_sel % 2 == 0:
        fastest = np.sort(host(port.scen.exp_base), -1)[..., :n_sel]
        lower = np.sort(fastest, -1)[..., n_sel // 2 - 1]
        lower_median = np.sort(lower, -1)[:, (M - 1) // 2]
        off = np.abs(lower_median / host(ref.scen.time_scale) - 1)
        assert off.max() > 1e-4


def test_calibrate_scales_matches_reference_directly():
    cfg = EnvConfig(num_devices=20, num_jobs=4, n_sel=6)
    exp_base = np.random.default_rng(0).random((3, 4, 20)).astype(np.float32)
    ts, fs = genv.calibrate_scales(cfg, t32(exp_base))
    for e in range(3):
        rts, rfs = ref_env.calibrate_scales(cfg, jnp.asarray(exp_base[e]))
        assert float(ts[e]) == pytest.approx(float(rts), rel=1e-6)
        assert float(fs[e]) == float(rfs)


def test_reset_shapes_and_calibration():
    cfg = small_cfg()
    state = reset(cfg, CURRICULA["default"], torch.Generator().manual_seed(0),
                  device=CPU)
    assert state.scen.a.shape == (1, 24)
    assert state.scen.data.shape == (1, 24, 2)
    assert state.scen.shift.shape == (1, 2, 24)
    assert state.counts.shape == (1, 2, 24)
    assert float(state.scen.time_scale) > 0
    assert float(state.scen.fairness_scale) > 0
    assert int(state.job) == 0 and int(state.t) == 0
    s = state.scen
    close(s.exp_base, host(s.taus)[:, :, None]
          * host(s.data).transpose(0, 2, 1)
          * (host(s.a) + 1.0 / host(s.mu))[:, None, :], rtol=1e-5)


def test_batched_scoring_rows_equal_single_calls():
    """The scoring core's leading batch dims: each row equals the 1-D call
    on that row's counts and plans, bit for bit."""
    g = torch.Generator().manual_seed(3)
    counts = torch.randn((5, 33), generator=g) * 4
    counts = counts - counts.mean(-1, keepdim=True)
    times = torch.rand((5, 33), generator=g)
    plans = (torch.rand((5, 7, 33), generator=g) < 0.2).to(torch.int8)
    for delta in (True, False):
        fb = scoring.fairness_dense(counts, plans, delta)
        for e in range(5):
            assert torch.equal(fb[e], scoring.fairness_dense(
                counts[e], plans[e], delta))
    rb = scoring.round_time_dense(times, plans)
    for e in range(5):
        assert torch.equal(rb[e], scoring.round_time_dense(times[e],
                                                           plans[e]))


# ---- one round, 16 steps over injected draws -----------------------------

@pytest.mark.parametrize("curriculum", ["default", "flaky", "arrivals",
                                        "faults"])
def test_apply_round_matches_reference(curriculum):
    K, M, NSEL, E, STEPS = 32, 3, 4, 4, 16
    spec = CURRICULA[curriculum]
    cfg = EnvConfig(num_devices=K, num_jobs=M, n_sel=NSEL)
    ref = ref_env.batch_reset(cfg, spec, jax.random.PRNGKey(5), E)
    port = convert.env_state_from_reference(ref, CPU)
    apply = jax.jit(jax.vmap(functools.partial(ref_env._apply_round, cfg)))
    release = jax.vmap(functools.partial(ref_env.release_instant, cfg))
    rng = np.random.default_rng(7)
    inactive = 0
    for i in range(STEPS):
        now = release(ref)
        avail = np.asarray(jax.vmap(ref_env.available_mask)(ref, now))
        active = np.asarray(jax.vmap(ref_env.job_active)(ref))
        plan = np.zeros((E, K), bool)
        for e in range(E):
            plan[e, rng.choice(np.flatnonzero(avail[e]), NSEL,
                               replace=False)] = active[e]
        inactive += int((~active).sum())
        draws = [rng.standard_exponential((E, K)).astype(np.float32)] + [
            rng.random((E, K)).astype(np.float32) for _ in range(3)]
        ref, rout = apply(ref, jnp.asarray(plan), *map(jnp.asarray, draws))
        assert bool(torch.equal(genv.job_active(port),
                               torch.as_tensor(active.copy())))
        port, pout = genv._apply_round(cfg, port, torch.as_tensor(plan),
                                       *map(t32, draws))
        for f in ("cost", "round_time", "fairness", "dfair", "reward", "now"):
            close(getattr(pout, f), getattr(rout, f), what=f"step {i} {f}")
        np.testing.assert_array_equal(host(pout.job), host(rout.job))
        np.testing.assert_array_equal(host(port.counts), host(ref.counts))
        np.testing.assert_array_equal(host(port.round_idx),
                                      host(ref.round_idx))
        np.testing.assert_array_equal(host(port.job), host(ref.job))
        np.testing.assert_array_equal(host(port.t), host(ref.t))
        close(port.busy_until, ref.busy_until, what=f"step {i} busy")
        close(port.job_clock, ref.job_clock, what=f"step {i} job_clock")
    if curriculum == "arrivals":
        assert inactive > 0   # the windows were exercised


# ---- engine parity (the port's engine and CostModel) ---------------------

class _Scripted(SchedulerBase):
    name = "scripted"

    def __init__(self, cost_model, plans):
        super().__init__(cost_model)
        self.plans = plans

    def schedule(self, ctx):
        return self.plans[ctx.round_idx]


class _StubRuntime:
    def run_round(self, job, device_ids, round_idx):
        return {"loss": 1.0, "accuracy": 0.0}


def test_gym_step_matches_engine_cost_model():
    """Gym round-time/fairness/cost == the port's MultiJobEngine +
    CostModel to 1e-5 when both consume the identical Formula-4 draws."""
    R, K, NSEL, TAU = 8, 40, 5, 3.0
    pool = DevicePool.heterogeneous(K, 1, seed=7)
    cm = CostModel(pool, alpha=4.0, beta=0.25, device=CPU)
    cm.calibrate([TAU], n_sel=NSEL)
    plans = random_plans(np.random.default_rng(3), np.ones(K, bool), NSEL, R)
    job = JobSpec(name="j", max_rounds=R,
                  local_epochs=int(TAU)).to_job_config(0)
    engine = MultiJobEngine([job], pool, cm, _Scripted(cm, plans),
                            _StubRuntime(), n_sel=NSEL)
    engine.run()
    assert len(engine.records) == R

    # An identical pool replays the engine's exact exponential draws (the
    # engine consumed pool.rng once per round, K draws each).
    pool2 = DevicePool.heterogeneous(K, 1, seed=7)
    cfg = EnvConfig(num_devices=K, num_jobs=1, n_sel=NSEL,
                    alpha=4.0, beta=0.25)
    state = state_from_pool(pool2, cm, taus=[TAU], device=CPU)
    no_fail = torch.ones((1, K))
    for r, rec in enumerate(engine.records):
        noise = pool2.rng.standard_exponential(K)
        state, out = genv._apply_round(cfg, state,
                                       torch.as_tensor(plans[r])[None],
                                       t32(noise)[None], no_fail)
        assert float(out.round_time) == pytest.approx(rec.round_time, rel=1e-5)
        assert float(out.fairness) == pytest.approx(rec.fairness,
                                                    rel=1e-5, abs=1e-6)
        assert float(out.cost) == pytest.approx(rec.cost, rel=1e-5, abs=1e-6)
    np.testing.assert_allclose(host(state.counts[0, 0]), engine.counts[0])


def test_gym_cost_honors_absolute_fairness():
    """delta_fairness=False: the gym cost uses the absolute Formula-5
    variance, matching the port's CostModel.cost."""
    K, NSEL = 30, 4
    pool = DevicePool.heterogeneous(K, 1, seed=5)
    cm = CostModel(pool, alpha=4.0, beta=0.25, delta_fairness=False,
                   device=CPU)
    cm.calibrate([2.0], n_sel=NSEL)
    cfg = genv.config_from_cost_model(cm, n_sel=NSEL)
    assert cfg.delta_fairness is False
    state = state_from_pool(pool, cm, taus=[2.0], device=CPU)
    counts = np.zeros((1, K), np.float32)
    counts[0, :5] = 3.0
    state = state._replace(counts=torch.as_tensor(counts)[None])
    plan = np.zeros(K, bool)
    plan[10:10 + NSEL] = True
    noise = np.random.default_rng(0).standard_exponential(K)
    _, out = genv._apply_round(cfg, state, torch.as_tensor(plan)[None],
                               t32(noise)[None], torch.ones((1, K)))
    times = 2.0 * pool.data_sizes[:, 0] * pool.a + noise * (
        2.0 * pool.data_sizes[:, 0] / pool.mu)
    expect = cm.cost(times, counts[0], plan)
    assert float(out.cost) == pytest.approx(expect, rel=1e-5, abs=1e-6)


def test_step_updates_dynamics():
    cfg = small_cfg()
    g = torch.Generator().manual_seed(2)
    state = reset(cfg, CURRICULA["default"], g, device=CPU)
    plan = torch.zeros((1, 24), dtype=torch.bool)
    plan[0, :3] = True
    state2, out = step(cfg, state, plan, g)
    assert int(state2.job) == 1 and int(state2.t) == 1
    assert host(state2.round_idx).tolist() == [[1, 0]]
    assert float(out.round_time) > 0 and np.isfinite(float(out.cost))
    assert (host(state2.busy_until)[0, :3] > 0).all()
    assert np.allclose(host(state2.counts)[0, 0, :3], 1.0)
    assert host(state.counts).sum() == 0   # the input state is untouched


def test_apply_round_indexes_each_envs_own_job():
    """Environments at different clocks (as ``state_from_pool`` states can
    be) step their own job, not a shared ``t % M``."""
    cfg = small_cfg(num_jobs=3)
    g = torch.Generator().manual_seed(4)
    state = batch_reset(cfg, CURRICULA["default"], g, 3, device=CPU)
    state = state._replace(job=torch.tensor([0, 2, 1]),
                           t=torch.tensor([0, 5, 7]))
    plan = torch.zeros((3, 24), dtype=torch.bool)
    plan[:, 4:7] = True
    nxt, out = genv._apply_round(cfg, state, plan, torch.ones((3, 24)),
                                 torch.ones((3, 24)))
    assert host(out.job).tolist() == [0, 2, 1]
    assert host(nxt.job).tolist() == [1, 0, 2]
    assert host(nxt.round_idx).tolist() == [[1, 0, 0], [0, 0, 1], [0, 1, 0]]
    for e, j in enumerate((0, 2, 1)):
        times = (state.scen.shift[e, j] + state.scen.scale[e, j])[4:7]
        assert float(out.round_time[e]) == float(times.max())


# ---- rollouts on injected noise -----------------------------------------

def plans_agree(ref_tr, port_tr, params, n_sel):
    """Compare plans step by step per env; at the first differing step an
    env's plans may differ only at a near tie of the reference's own
    ``logit + Gumbel`` at the n_sel boundary, and that env is compared no
    further. Returns {env: first comparable-steps count} and the flips."""
    ref_plan = np.asarray(ref_tr["plan"])
    port_plan = host(port_tr.plan)
    E, T, _ = ref_plan.shape
    upto, flips = {}, []
    for e in range(E):
        upto[e] = T
        for t in range(T):
            if np.array_equal(ref_plan[e, t], port_plan[e, t]):
                continue
            logits = np.asarray(ref_rlds._policy_logits(
                params, jnp.asarray(ref_tr["feats"][e, t])))
            keys = np.where(ref_tr["available"][e, t],
                            logits + ref_tr["gumbel"][e, t], -np.inf)
            top = np.sort(keys)[::-1]
            gap = top[n_sel - 1] - top[n_sel]
            assert gap <= NEAR_TIE * max(1.0, abs(top[n_sel - 1])), (e, t, gap)
            flips.append((e, t, float(gap)))
            upto[e] = t
            break
    return upto, flips


@pytest.mark.parametrize("curriculum,E,deterministic", [
    ("flaky", 1, False), ("faults", 4, False), ("arrivals", 4, False),
    ("full", 4, True),
], ids=["policy-flaky-E1", "batch-faults", "batch-arrivals",
        "batch-full-deterministic"])
def test_policy_rollout_matches_reference(curriculum, E, deterministic):
    K, M, NSEL, T = 24, 3, 3, 8
    spec = CURRICULA[curriculum]
    cfg = EnvConfig(num_devices=K, num_jobs=M, n_sel=NSEL)
    params = ref_params(5)
    key = jax.random.PRNGKey(9)
    if E == 1:
        state = ref_env.reset(cfg, spec, key)
        _, tr = ref_env.policy_rollout(cfg, params, state, T, deterministic)
        tr = jax.tree_util.tree_map(lambda x: np.asarray(x)[None], tr)
        states = jax.tree_util.tree_map(lambda x: x[None], state)
    else:
        states = ref_env.batch_reset(cfg, spec, key, E)
        _, tr = jax.jit(ref_env.batch_rollout, static_argnums=(0, 3, 4))(
            cfg, params, states, T, deterministic)
    noise = ref_rollout_noise(states, T, K, deterministic)
    port_state = convert.env_state_from_reference(states, CPU)
    fn = policy_rollout if E == 1 else batch_rollout
    _, ptr = fn(cfg, port_params(params), port_state, T,
                deterministic=deterministic, noise=noise)
    assert ptr.plan.shape == (E, T, K)
    ref_tr = {f: np.asarray(getattr(tr, f)) for f in tr._fields}
    ref_tr["gumbel"] = host(noise[2])
    upto, flips = plans_agree(ref_tr, ptr, params, NSEL)
    if flips:
        print(f"near-tie plan flips (env, step, gap): {flips}")
    for e, n in upto.items():
        sl = (e, slice(0, n))
        close(ptr.feats[sl], ref_tr["feats"][sl], rtol=1e-5, atol=1e-5)
        close(ptr.cost[sl], ref_tr["cost"][sl])
        close(ptr.round_time[sl], ref_tr["round_time"][sl])
        close(ptr.reward[sl], ref_tr["reward"][sl])
        np.testing.assert_array_equal(host(ptr.available[sl]),
                                      ref_tr["available"][sl])
        np.testing.assert_array_equal(host(ptr.job[sl]), ref_tr["job"][sl])
    assert sum(upto.values()) >= E * T // 2


@pytest.mark.parametrize("curriculum", ["default", "faults"])
def test_random_rollout_matches_reference(curriculum):
    K, M, NSEL, T, E = 24, 2, 3, 8, 4
    spec = CURRICULA[curriculum]
    cfg = EnvConfig(num_devices=K, num_jobs=M, n_sel=NSEL)
    states = ref_env.batch_reset(cfg, spec, jax.random.PRNGKey(3), E)
    final, out = jax.jit(ref_env.batch_random_rollout,
                         static_argnums=(0, 2))(cfg, states, T)
    noise = ref_rollout_noise(states, T, K)
    pfinal, pout = genv.batch_random_rollout(
        cfg, convert.env_state_from_reference(states, CPU), T, noise=noise)
    assert pout.cost.shape == (E, T)
    for f in ("cost", "round_time", "fairness", "dfair", "now"):
        close(getattr(pout, f), getattr(out, f), what=f)
    np.testing.assert_array_equal(host(pfinal.counts), host(final.counts))
    close(pfinal.busy_until, final.busy_until)


def test_rollout_plans_valid_and_batched():
    """Every sampled plan: exactly n_sel devices, all available."""
    cfg = small_cfg()
    g = torch.Generator().manual_seed(3)
    params = init_policy(torch.Generator().manual_seed(0))
    states = batch_reset(cfg, CURRICULA["flaky"], g, 3, device=CPU)
    _, tr = batch_rollout(cfg, params, states, 12, generator=g)
    assert tr.plan.shape == (3, 12, 24)
    assert bool((tr.plan.sum(-1) == cfg.n_sel).all())
    assert not bool((tr.plan & ~tr.available).any())
    assert bool(torch.isfinite(tr.cost).all())
    with pytest.raises(ValueError, match="generator or pre-drawn noise"):
        batch_rollout(cfg, params, states, 2)


def test_greedy_and_sampled_plans():
    logits = torch.tensor([[0.3, 2.0, -1.0, 1.0, 0.5]])
    avail = torch.tensor([[True, False, True, True, True]])
    plan = genv.greedy_plan(logits, avail, 2)
    assert host(plan).tolist() == [[False, False, False, True, True]]
    g = torch.Generator().manual_seed(0)
    for _ in range(5):
        p = genv.sample_plan(g, logits, avail, 2)
        assert int(p.sum()) == 2 and not bool((p & ~avail).any())
    # fewer available than n_sel: a smaller plan, never a busy device
    few = torch.tensor([[False, True, False, False, False]])
    assert host(genv.greedy_plan(logits, few, 2)).tolist() == [
        [False, True, False, False, False]]


def test_inactive_job_round_is_noop():
    cfg = small_cfg()
    g = torch.Generator().manual_seed(3)
    state = reset(cfg, CURRICULA["default"], g, device=CPU)
    far = torch.full((1, cfg.num_jobs), 1e9)
    state = state._replace(scen=state.scen._replace(job_start=far))
    assert not bool(genv.job_active(state))
    final, out = genv.random_rollout(cfg, state, 6, generator=g)
    np.testing.assert_array_equal(host(out.cost), 0.0)
    np.testing.assert_array_equal(host(out.round_time), 0.0)
    np.testing.assert_array_equal(host(final.counts), host(state.counts))


def test_arrivals_rollout_masks_inactive_jobs():
    cfg = small_cfg(num_jobs=4)
    g = torch.Generator().manual_seed(4)
    states = batch_reset(cfg, CURRICULA["arrivals"], g, 6, device=CPU)
    params = init_policy(torch.Generator().manual_seed(5))
    _, tr = batch_rollout(cfg, params, states, 40, generator=g)
    plans, jobs = host(tr.plan), host(tr.job)
    start, end = host(states.scen.job_start), host(states.scen.job_end)
    t = np.arange(jobs.shape[1])[None, :]
    active = ((np.take_along_axis(start, jobs, axis=1) <= t)
              & (t < np.take_along_axis(end, jobs, axis=1)))
    assert (plans.sum(-1)[~active] == 0).all()
    assert bool(active.any()) and bool((~active).any())


# ---- one training iteration on the reference's draws ---------------------

def ref_iter_draws(cfg, spec, tcfg, key):
    """The draws of the reference's jitted iteration: its (reset,
    permutation) split, the per-env scenario and rollout keys."""
    E, T, K = tcfg.num_envs, tcfg.rollout_len, cfg.num_devices
    k_reset, k_perm = jax.random.split(key)
    states = ref_env.batch_reset(cfg, spec, k_reset, E)
    draw = convert.env_state_from_reference(
        ref_scenario_draw(k_reset, spec, K, cfg.num_jobs, E), CPU)
    perm = torch.as_tensor(np.asarray(
        jax.random.permutation(k_perm, E * T)).astype(np.int64))
    return states, k_perm, gtrain.IterDraws(
        draw, ref_rollout_noise(states, T, K), perm)


def ref_iter_unrolled(cfg, tcfg, params, opt_state, baselines, states, k_perm,
                      opt_update):
    """The reference's iteration, step by step outside jit, keeping each
    minibatch's gradients (the jitted one gives only its results)."""
    E, T, M, K = tcfg.num_envs, tcfg.rollout_len, cfg.num_jobs, cfg.num_devices
    B = E * T
    nb = max(1, min(tcfg.minibatches, B))
    mb = B // nb
    _, tr = ref_env.batch_rollout(cfg, params, states, T)
    rewards = tr.reward
    onehot = jax.nn.one_hot(tr.job, M)
    per_job_n = jnp.maximum(onehot.sum((0, 1)), 1.0)
    per_job_mean = jnp.einsum("et,etm->m", rewards, onehot) / per_job_n
    baselines = jnp.where(jnp.isnan(baselines), per_job_mean, baselines)
    adv = rewards - baselines[tr.job]
    adv = (adv - adv.mean()) / (adv.std() + 1e-8)
    feats = tr.feats.reshape(B, K, -1)
    plans = tr.plan.reshape(B, -1).astype(jnp.float32)
    avail = tr.available.reshape(B, -1).astype(jnp.float32)
    advf = adv.reshape(B)
    idx = jax.random.permutation(k_perm, B)[: nb * mb].reshape(nb, mb)
    grads_seen = []
    p, s = params, opt_state
    for i in idx:
        grads = ref_rlds._reinforce_grads(p, feats[i], plans[i], avail[i],
                                          advf[i])
        grads_seen.append(grads)
        updates, s = opt_update(grads, s, p)
        p = jax.tree_util.tree_map(lambda a, u: a + u, p, updates)
    return p, grads_seen


def test_train_iter_matches_reference(monkeypatch):
    """One iteration on the reference's draws and initial params: logs
    within 1e-5 of the jitted reference, each minibatch's gradient within
    1e-4 of its norm, and the params after the step.

    The params' tolerance: AdamW's step moves a weight by lr times a ratio
    of that weight's own gradient entries (the first step by about
    ``lr * g / (|g| + eps)``, whatever |g|), so an entry whose two gradients
    differ by a relative r moves the weight by about lr * r more or less,
    and a near-zero entry (r near 1, where the two frameworks' f32
    rounding decides its sign) by up to 2 lr. Each weight is held to
    ``1e-6 + 2 lr sum_i min(1, r_i)`` over its minibatch steps i, against a
    replica of the reference's iteration run step by step (the jitted one
    does not show its gradients); the replica is held to the jitted
    iteration within 1e-4 (XLA's fused rounding, through the same ratio).
    """
    cfg, spec = default_stages("full", num_devices=(24,), num_jobs=2)[0]
    tcfg = TrainConfig(num_envs=4, rollout_len=6, iters=1, minibatches=2)
    key = jax.random.PRNGKey(2)
    params = ref_params(1)
    opt_init, opt_update = ref_rlds.policy_optimizer(tcfg.lr)
    opt_state = opt_init(params)
    baselines = jnp.full((cfg.num_jobs,), jnp.nan)
    ref_it = ref_train._make_train_iter(cfg, spec, tcfg, opt_update)
    rp, _, rbase, rlog = ref_it(params, opt_state, baselines, key)

    states, k_perm, draws = ref_iter_draws(cfg, spec, tcfg, key)
    up, ugrads = ref_iter_unrolled(cfg, tcfg, params, opt_state, baselines,
                                   states, k_perm, opt_update)
    for k in params:
        close(up[k], rp[k], rtol=0, atol=1e-4, what=k)

    seen = []
    orig = gtrain._reinforce_grads

    def keep(*a):
        seen.append(orig(*a))
        return seen[-1]

    monkeypatch.setattr(gtrain, "_reinforce_grads", keep)
    p_init, p_update = gtrain.policy_optimizer(tcfg.lr)
    pp = port_params(params)
    it = gtrain.make_train_iter(cfg, spec, tcfg, p_update)
    pp2, _, pbase, plog = it(pp, p_init(pp),
                             torch.full((cfg.num_jobs,), torch.nan), draws)
    for k in ("mean_cost", "mean_reward", "mean_round_time"):
        assert float(plog[k]) == pytest.approx(float(rlog[k]), rel=1e-5), k
    close(pbase, rbase)
    assert len(seen) == len(ugrads) == tcfg.minibatches
    rel = {k: 0.0 for k in params}
    for gp, gr in zip(seen, ugrads):
        norm = np.sqrt(sum(float(jnp.sum(jnp.square(v))) for v in gr.values()))
        for k in gr:
            g = np.abs(np.asarray(gr[k]))
            d = np.abs(host(gp[k]) - np.asarray(gr[k]))
            assert d.max() <= 1e-4 * norm, k
            rel[k] = rel[k] + np.minimum(1.0, d / np.maximum(g, 1e-30))
    for k in params:
        diff = np.abs(host(pp2[k]) - np.asarray(up[k]))
        assert (diff <= 1e-6 + 2 * tcfg.lr * rel[k]).all(), k


def test_train_rlds_runs_and_changes_params():
    stages = default_stages("default", num_devices=(24,), num_jobs=2)
    tcfg = TrainConfig(num_envs=4, rollout_len=6, iters=3, minibatches=2)
    params, logs = train_rlds(stages, tcfg, seed=0, device=CPU)
    assert len(logs) == 3
    assert all(np.isfinite(l["mean_cost"]) for l in logs)
    fresh = init_policy(torch.Generator().manual_seed(0))
    assert any(not torch.allclose(params[k], fresh[k]) for k in params)
    ev = evaluate(stages[0][0], stages[0][1], params, seed=1, episodes=4,
                  steps=8, device=CPU)
    assert np.isfinite(ev["mean_cost"])
    # deterministic evaluation pairs scenarios: same seed, same result
    assert evaluate(stages[0][0], stages[0][1], params, seed=1, episodes=4,
                    steps=8, device=CPU) == ev


def test_train_rlds_cycles_stages_and_is_seeded():
    stages = default_stages("full", num_devices=(24, 30), num_jobs=2)
    tcfg = TrainConfig(num_envs=2, rollout_len=4, iters=4, minibatches=2)
    a, logs = train_rlds(stages, tcfg, seed=3, device=CPU)
    b, _ = train_rlds(stages, tcfg, seed=3, device=CPU)
    assert [l["stage"] for l in logs] == [0, 1, 0, 1]
    for k in a:
        assert torch.equal(a[k], b[k])


def test_entry_points_default_to_cuda():
    import inspect

    for fn in (train_rlds, evaluate, batch_reset, reset, state_from_pool,
               genv.make_scenario):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            train_rlds(default_stages(num_devices=(24,)),
                       TrainConfig(iters=1))
