"""The paper's schedulers in the port (BODS, RLDS, and the DNN baseline)
vs the reference, end to end on the CPU.

Whole ``quickstart`` runs give the reference's ``RoundRecord``s: BODS on
its host search (its fused candidates are ``jax.random`` draws), RLDS from
the reference's ``init_policy`` params (carried over with
``convert.rlds_state_from_reference``) and a short pretraining, and DNN
(its MLP drawn from the numpy ``rng``, bit for bit). The two frameworks
round f32 sums differently, so a decision may go the other way where the
scores it picks between are within 1e-5 of each other; every decision's
scores are logged on both sides, and the test accepts a difference only at
such a near tie (relative to the larger score). Records of the decisions
made before that one must still be identical; later ones are not compared.
Also: the fused BODS default on the paper's presets, the scheduler-state
converters both ways, lazy pretraining, and the persistence protocol.
"""

import copy
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core.schedulers import bods as ref_bods  # noqa: E402
from repro.core.schedulers import dnn as ref_dnn  # noqa: E402
from repro.core.schedulers import rlds as ref_rlds  # noqa: E402
from repro.experiment import presets as ref_presets  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.cost import CostModel  # noqa: E402
from repro_torch.core.devices import DevicePool  # noqa: E402
from repro_torch.core.plans import validate_plan  # noqa: E402
from repro_torch.core.schedulers import bods, dnn, get_scheduler, rlds  # noqa: E402
from repro_torch.core.schedulers.base import SchedulingContext  # noqa: E402
from repro_torch.experiment import presets  # noqa: E402

NEAR_TIE = 1e-5
ROUNDS = 15


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def twin_specs(preset, scheduler, max_rounds=ROUNDS, **replace):
    out = []
    for mod in (ref_presets, presets):
        spec = mod.get_preset(preset, scheduler=scheduler,
                              max_rounds=max_rounds)
        out.append(spec.replace(scoring_backend="numpy", **replace))
    return out


def record_dict(r):
    d = dataclasses.asdict(r)
    for key in ("device_ids", "dropped", "corrupt_ids", "failed_ids"):
        d[key] = np.asarray(d[key]).astype(int).tolist()
    return d


class Decisions:
    """Wraps a scheduler class's ``schedule``: logs each decision's
    (job, round) key, so a logged pick can name the decision it is in."""

    def __init__(self, monkeypatch, cls):
        self.keys = []
        schedule = cls.schedule

        def logged(sched, ctx):
            self.keys.append((int(ctx.job), int(ctx.round_idx)))
            return schedule(sched, ctx)

        monkeypatch.setattr(cls, "schedule", logged)

    def current(self) -> int:
        return len(self.keys) - 1


class ScoreLog:
    """A stand-in for a scheduler module's ``np`` that logs the array every
    ``pick`` (argmax/argmin) call decides on, and the decision it is in
    (``decisions.current()``); all else is numpy."""

    def __init__(self, pick, decisions):
        self.pick, self.decisions = pick, decisions
        self.scores, self.at = [], []

    def __getattr__(self, name):
        fn = getattr(np, name)
        if name != self.pick:
            return fn

        def logged(a, *args, **kw):
            self.scores.append(np.array(a, np.float64))
            self.at.append(self.decisions.current())
            return fn(a, *args, **kw)

        return logged


def first_split(ref_scores, port_scores, pick):
    """The first logged decision on which the two sides chose differently;
    asserts that it is a near tie in the reference's own scores."""
    choose = np.argmax if pick == "argmax" else np.argmin
    for i, (a, b) in enumerate(zip(ref_scores, port_scores)):
        ia, ib = int(choose(a)), int(choose(b))
        if ia != ib:
            gap = abs(a[ia] - a[ib])
            assert gap <= NEAR_TIE * max(1.0, abs(a[ia])), (i, gap)
            return i
    return None


def assert_runs_agree(a, b, ref_keys, port_keys, split):
    """Every record agrees if no decision split (``split`` is None);
    otherwise the records of the decisions made before decision ``split``,
    which both sides made alike, in the order they were recorded."""
    assert len(a) > 0
    if split is None:
        assert len(a) == len(b)
        for ra, rb in zip(a, b):
            assert record_dict(ra) == record_dict(rb)
        return
    assert ref_keys[:split] == port_keys[:split]
    before = set(ref_keys[:split])

    def kept(records):
        return [record_dict(r) for r in records
                if (r.job, r.round_idx) in before]

    assert len(kept(a)) == len(before)
    assert kept(a) == kept(b)


@pytest.mark.parametrize("scheduler,module,port_module,pick", [
    ("bods", ref_bods, bods, "argmax"),
    ("dnn", ref_dnn, dnn, "argmin"),
], ids=["bods-host", "dnn"])
def test_quickstart_records_match_reference(monkeypatch, scheduler, module,
                                            port_module, pick):
    ref_spec, port_spec = twin_specs("quickstart", scheduler,
                                     search_backend="host")
    assert ref_spec.to_dict() == port_spec.to_dict()
    if scheduler == "dnn":
        # The reference's observe() hands its replay ring to the jitted SGD
        # step without a copy (jnp.asarray is zero-copy on the CPU) and
        # refills the ring in place at the next observe(), while the step
        # may still run under asynchronous dispatch; on a loaded host the
        # step then reads a later ring. Wait for each step to finish.
        step = ref_dnn._sgd_step
        monkeypatch.setattr(ref_dnn, "_sgd_step",
                            lambda *a: jax.block_until_ready(step(*a)))
    cls = {"bods": "BODSScheduler", "dnn": "DNNScheduler"}[scheduler]
    ref_dec = Decisions(monkeypatch, getattr(module, cls))
    port_dec = Decisions(monkeypatch, getattr(port_module, cls))
    ref_log, port_log = ScoreLog(pick, ref_dec), ScoreLog(pick, port_dec)
    monkeypatch.setattr(module, "np", ref_log)
    monkeypatch.setattr(port_module, "np", port_log)
    a = ref_spec.run().records
    b = port_spec.run(device="cpu").records
    assert len(port_log.scores) > 0
    split = first_split(ref_log.scores, port_log.scores, pick)
    assert_runs_agree(a, b, ref_dec.keys, port_dec.keys,
                      None if split is None else ref_log.at[split])


def gumbel_keys_logger(orig, log, decisions):
    """Wrap ``gumbel_topk_plans``: log each call's Gumbel keys (replayed
    from the generator's state before the call), its plans, and the
    decision it is in (pretraining's draws are in decision 0)."""

    def logged(rng, logits, available, n_sel):
        state = copy.deepcopy(rng.bit_generator.state)
        out = orig(rng, logits, available, n_sel)
        replay = np.random.Generator(type(rng.bit_generator)())
        replay.bit_generator.state = state
        lg = np.atleast_2d(np.asarray(logits, np.float64))
        keys = np.where(available[None, :],
                        lg + replay.gumbel(size=lg.shape), -np.inf)
        log.append((keys, out, decisions.current()))
        return out

    return logged


def test_rlds_quickstart_records_match_reference(monkeypatch):
    """RLDS from the reference's initial params and pretraining: every
    policy draw (pretraining's and the rounds') takes the reference's
    plan, unless its Gumbel keys tie within 1e-5 at the n_sel boundary."""
    ref_spec, port_spec = twin_specs(
        "quickstart", "rlds", scheduler_kwargs={"pretrain_rounds": 5})
    ref_exp, port_exp = ref_spec.build(), port_spec.build(device="cpu")
    port_exp.engine.scheduler.load_state_dict(convert.rlds_state_from_reference(
        ref_exp.engine.scheduler.state_dict(), device="cpu"))
    logs = {"ref": [], "port": []}
    dec = {}
    for mod, key in ((ref_rlds, "ref"), (rlds, "port")):
        dec[key] = Decisions(monkeypatch, mod.RLDSScheduler)
        monkeypatch.setattr(mod, "gumbel_topk_plans", gumbel_keys_logger(
            mod.gumbel_topk_plans, logs[key], dec[key]))
    a = ref_exp.run().records
    b = port_exp.run().records
    assert len(logs["port"]) >= 5 * 8
    split = None
    for i, ((ka, pa, at), (_, pb, _)) in enumerate(zip(logs["ref"],
                                                       logs["port"])):
        if not np.array_equal(pa, pb):
            n_sel = int(pa[0].sum())
            top = np.sort(ka[0])[::-1]
            gap = top[n_sel - 1] - top[n_sel]
            assert gap <= NEAR_TIE * max(1.0, abs(top[n_sel - 1])), (i, gap)
            split = at
            break
    assert_runs_agree(a, b, dec["ref"].keys, dec["port"].keys, split)


# ---- the fused default on the paper's presets ------------------------------

def check_records(records, n_sel, K):
    assert records
    for r in records:
        ids = np.asarray(r.device_ids)
        assert ids.size == n_sel and np.unique(ids).size == n_sel
        assert ids.min() >= 0 and ids.max() < K
        assert np.isfinite(r.est_cost) and r.round_time > 0


@pytest.mark.parametrize("preset", ["paper-group-a", "paper-group-b",
                                    "quickstart"])
def test_paper_presets_run_fused_bods_by_default(preset):
    spec = presets.get_preset(preset, max_rounds=12)
    assert spec.scheduler == "bods"
    assert spec.effective_search_backend() == "fused"
    exp = spec.build(device="cpu")
    assert isinstance(exp.engine.scheduler, bods.BODSScheduler)
    res = exp.run()
    check_records(res.records, spec.effective_n_sel(),
                  spec.effective_num_devices())
    again = spec.run(device="cpu")
    assert [record_dict(r) for r in again.records] == \
        [record_dict(r) for r in res.records]


def test_fused_bods_comparable_and_beats_random():
    """The fused acquisition stays in the host path's cost band and below
    random selection (the reference's statistical check, on the port)."""
    def mean_cost(name, kw):
        out = []
        for sd in range(4):
            pool = DevicePool.heterogeneous(80, 2, seed=sd)
            cm = CostModel(pool, alpha=4.0, beta=0.25, device="cpu")
            cm.calibrate([5.0, 5.0], n_sel=8)
            rng = np.random.default_rng(sd + 1000)
            counts = rng.integers(0, 8, 80).astype(np.float64)
            avail = np.ones(80, bool)
            avail[rng.choice(80, 16, replace=False)] = False
            sched = get_scheduler(name, cost_model=cm, seed=sd, **kw)
            for _ in range(2):
                ctx = SchedulingContext(
                    job=0, round_idx=0, tau=5.0, n_sel=8, available=avail,
                    counts=counts, expected_times=pool.expected_times(0, 5.0))
                validate_plan(sched.schedule(ctx), avail, 8)
                out.append(sched.last_estimated_cost)
        return float(np.mean(out))

    host = mean_cost("bods", dict(search_backend="host"))
    fused = mean_cost("bods", dict(search_backend="fused"))
    rand = mean_cost("random", {})
    assert fused <= host * 1.15, (fused, host)
    assert fused < rand, (fused, rand)


# ---- RLDS: lazy pretraining, state -----------------------------------------

def small_cm(K=30, M=2):
    pool = DevicePool.heterogeneous(K, M, seed=0)
    cm = CostModel(pool, device="cpu")
    cm.calibrate([5.0] * M, n_sel=3)
    return pool, cm


def ctx_for(pool, n_sel=3, job=0):
    K = pool.num_devices
    return SchedulingContext(job=job, round_idx=0, tau=5.0, n_sel=n_sel,
                             available=np.ones(K, bool), counts=np.zeros(K),
                             expected_times=pool.expected_times(job, 5.0))


def test_rlds_pretrain_flag_set_only_after_it_returns(monkeypatch):
    pool, cm = small_cm()
    sched = get_scheduler("rlds", cost_model=cm, seed=0, pretrain_rounds=3)
    calls = {"n": 0}
    update = sched._update

    def failing(**kw):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("interrupted")
        return update(**kw)

    monkeypatch.setattr(sched, "_update", failing)
    with pytest.raises(RuntimeError, match="interrupted"):
        sched.schedule(ctx_for(pool))
    assert not sched._pretrained
    monkeypatch.setattr(sched, "_update", update)
    validate_plan(sched.schedule(ctx_for(pool)), np.ones(30, bool), 3)
    assert sched._pretrained


def test_rlds_state_dict_round_trip_and_shape_check():
    pool, cm = small_cm()
    a = get_scheduler("rlds", cost_model=cm, seed=1, pretrain_rounds=2)
    a.schedule(ctx_for(pool))
    b = get_scheduler("rlds", cost_model=cm, seed=2, pretrain_rounds=2)
    b.load_state_dict(a.state_dict())
    assert b._pretrained and int(b.opt_state.step) == 2
    ctx = ctx_for(pool)
    a.rng = np.random.default_rng(9)
    b.rng = np.random.default_rng(9)
    np.testing.assert_array_equal(a.schedule(ctx), b.schedule(ctx))
    bad = a.state_dict()
    bad["params"] = dict(bad["params"], wh=torch.zeros(3, 3))
    with pytest.raises(ValueError, match="policy shapes"):
        b.load_state_dict(bad)
    # a baseline vector of another job mix resets to unset
    other = dict(a.state_dict(), baselines=np.zeros(5))
    b.load_state_dict(other)
    assert np.all(np.isnan(b.baselines))


# ---- the converters, both ways ---------------------------------------------

def ref_and_port(name, **kw):
    ref_spec, port_spec = twin_specs("quickstart", name, max_rounds=4,
                                     search_backend="host",
                                     scheduler_kwargs=kw)
    ref_exp, port_exp = ref_spec.build(), port_spec.build(device="cpu")
    ref_exp.run()
    return ref_exp.engine.scheduler, port_exp.engine.scheduler


def assert_trees_equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            assert_trees_equal(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_trees_equal(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_bods_state_converters_round_trip():
    ref, port = ref_and_port("bods")
    tree = ref.state_dict()
    port.load_state_dict(convert.bods_state_from_reference(tree))
    back = convert.bods_state_from_reference(port.state_dict())
    assert_trees_equal(back, tree)
    assert back["F"] is not tree["F"]
    ref.load_state_dict(back)
    assert_trees_equal(ref.state_dict(), tree)


def test_rlds_state_converters_round_trip():
    """Reference state -> port -> reference is exact; one update from the
    carried state moves both packages' params alike (within 1e-6)."""
    ref, port = ref_and_port("rlds", pretrain_rounds=2)
    tree = ref.state_dict()
    port.load_state_dict(convert.rlds_state_from_reference(tree, "cpu"))
    back = convert.rlds_state_to_reference(port.state_dict())
    assert_trees_equal(back["params"], tree["params"])
    assert_trees_equal(tuple(back["opt"]), tuple(tree["opt"]))
    for key in ("baselines", "adv_scale", "pretrained"):
        np.testing.assert_array_equal(back[key], tree[key])
    ref.load_state_dict(back)
    rng = np.random.default_rng(0)
    K = port.cost_model.pool.num_devices
    batch = dict(feats=rng.random((2, K, 6)).astype(np.float32),
                 plans=(rng.random((2, K)) < 0.1).astype(np.float32),
                 avail=np.ones((2, K), np.float32),
                 advantages=np.array([0.5, -1.0], np.float32))
    ref._update(**batch)
    port._update(**batch)
    after = convert.rlds_state_to_reference(port.state_dict())
    for k, v in ref.state_dict()["params"].items():
        np.testing.assert_allclose(after["params"][k], np.asarray(v),
                                   rtol=0, atol=1e-6)
    assert int(after["opt"].step) == int(ref.state_dict()["opt"].step)


def test_dnn_state_converters_round_trip():
    ref, port = ref_and_port("dnn")
    tree = ref.state_dict()
    port.load_state_dict(convert.dnn_state_from_reference(tree, "cpu"))
    back = convert.dnn_state_to_reference(port.state_dict())
    assert_trees_equal(back, {k: (dict(v) if k == "params" else v)
                              for k, v in tree.items()})
    ref.load_state_dict(back)


# ---- BODS persistence: job set, warm hand-off -------------------------------

def test_bods_job_state_warm_handoff_and_growth():
    pool, cm = small_cm(K=40, M=2)
    a = get_scheduler("bods", cost_model=cm, seed=0, num_candidates=32)
    ctx = ctx_for(pool, n_sel=4)
    for _ in range(3):
        plan = a.schedule(ctx)
        a.observe(ctx, plan, 1.0)
    a.ensure_jobs(4)
    assert a._F.shape[0] == 4 and not a._initialized[2:].any()
    saved = a.job_state_dict(0)
    a.load_job_state(3, saved)
    np.testing.assert_array_equal(a._plans[3], a._plans[0])
    assert a._head[3] == a._head[0] and a._initialized[3]
    with pytest.raises(ValueError, match="ring shape"):
        a.load_job_state(1, dict(saved, plans=np.zeros((4, 5), bool)))
    snap = copy.deepcopy(a.snapshot())
    first = a.schedule(ctx)
    a.restore(snap)
    np.testing.assert_array_equal(a.schedule(ctx), first)
