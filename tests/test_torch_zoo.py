"""The policy zoo and the ``policy`` axis in the port vs the reference, on
the CPU: bit-exact round trips within the port and across the two packages
(either writes, the other loads) for RLDS, DNN and BODS entries; the
refusals; ``save_rlds_params``'s tree against the reference's; spec builds
that warm-start from a reference-written entry and give the reference's
records; and ``python -m repro_torch.gym`` in a subprocess.
"""

import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import gym as ref_gym  # noqa: E402
from repro.core.cost import CostModel as RefCostModel  # noqa: E402
from repro.core.devices import DevicePool as RefPool  # noqa: E402
from repro.core.schedulers import dnn as ref_dnn  # noqa: E402
from repro.core.schedulers import get_scheduler as ref_get  # noqa: E402
from repro.core.schedulers import rlds as ref_rlds  # noqa: E402
from repro.core.schedulers.base import (  # noqa: E402
    SchedulingContext as RefCtx)
from repro.experiment import spec as ref_spec_mod  # noqa: E402
from repro.experiment import presets as ref_presets  # noqa: E402
from repro_torch.core.cost import CostModel  # noqa: E402
from repro_torch.core.devices import DevicePool  # noqa: E402
from repro_torch.core.schedulers import get_scheduler, rlds  # noqa: E402
from repro_torch.core.schedulers.base import SchedulingContext  # noqa: E402
from repro_torch.experiment import presets  # noqa: E402
from repro_torch.experiment.spec import (ExperimentSpec, JobSpec,  # noqa: E402
                                         PoolSpec)
from repro_torch.gym import (PolicyZoo, TrainConfig,  # noqa: E402
                             default_stages, save_rlds_params, train_rlds)
from repro_torch.tree import tree_flatten_with_paths  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
NEAR_TIE = 1e-5
K, M, NSEL = 24, 2, 3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def leaves(tree):
    """(path, numpy leaf) in the checkpoint's order, either package's tree
    (the port's flattening visits JAX's order; tested in
    test_torch_checkpoint.py)."""
    return [(p, host(v)) for p, v in tree_flatten_with_paths(tree)]


def assert_trees_equal(a, b):
    la, lb = leaves(a), leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, p
        np.testing.assert_array_equal(x, y, err_msg=p)


def port_scheduler(name, seed, pool_seed=0, num_devices=K, **kw):
    pool = DevicePool.heterogeneous(num_devices, M, seed=pool_seed)
    cm = CostModel(pool, device="cpu")
    cm.calibrate([5.0] * M, n_sel=NSEL)
    if name == "rlds":
        kw.setdefault("pretrain_rounds", 0)
    return get_scheduler(name, cost_model=cm, seed=seed, **kw)


def ref_scheduler(name, seed, pool_seed=0, num_devices=K, **kw):
    pool = RefPool.heterogeneous(num_devices, M, seed=pool_seed)
    cm = RefCostModel(pool)
    cm.calibrate([5.0] * M, n_sel=NSEL)
    if name == "rlds":
        kw.setdefault("pretrain_rounds", 0)
    return ref_get(name, cost_model=cm, seed=seed, **kw)


def drive(sched, ctx_cls, rounds=3):
    """Push real state through a scheduler (decisions and observations)."""
    pool = sched.cost_model.pool
    rng = np.random.default_rng(0)
    counts = np.zeros(pool.num_devices)
    for r in range(rounds):
        ctx = ctx_cls(job=r % M, round_idx=r, tau=5.0, n_sel=NSEL,
                      available=np.ones(pool.num_devices, dtype=bool),
                      counts=counts.copy(),
                      expected_times=pool.expected_times(r % M, 5.0))
        plan = sched.schedule(ctx)
        sched.observe(ctx, plan, float(rng.random()))
        counts += plan
    return sched


LEARNERS = {"rlds": {"pretrain_rounds": 2}, "dnn": {}, "bods": {}}


@pytest.mark.parametrize("name", list(LEARNERS))
def test_zoo_bit_exact_roundtrip(name, tmp_path):
    """state_dict -> zoo save -> load into a FRESH port scheduler restores
    every leaf bit for bit (RLDS params/opt, DNN ring, BODS rings)."""
    sched = drive(port_scheduler(name, 3, **LEARNERS[name]),
                  SchedulingContext)
    zoo = PolicyZoo(str(tmp_path))
    zoo.save_scheduler("p", sched, meta={"note": "test"})
    fresh = port_scheduler(name, 99)
    assert zoo.load_into("p", fresh) == {"note": "test"}
    assert_trees_equal(sched.state_dict(), fresh.state_dict())
    assert zoo.names() == ["p"] and zoo.info("p")["kind"] == name


@pytest.mark.parametrize("name", list(LEARNERS))
@pytest.mark.parametrize("direction", ["port-to-reference",
                                       "reference-to-port"])
def test_zoo_entries_cross_packages(name, direction, tmp_path):
    """An entry either package writes loads bit-exact into the other's
    scheduler through that package's own ``PolicyZoo``."""
    if direction == "port-to-reference":
        src = drive(port_scheduler(name, 3, **LEARNERS[name]),
                    SchedulingContext)
        PolicyZoo(str(tmp_path)).save_scheduler("p", src, meta={"by": "port"})
        dst = ref_scheduler(name, 99)
        meta = ref_gym.PolicyZoo(str(tmp_path)).load_into("p", dst)
        assert meta == {"by": "port"}
    else:
        src = drive(ref_scheduler(name, 3, **LEARNERS[name]), RefCtx)
        ref_gym.PolicyZoo(str(tmp_path)).save_scheduler("p", src,
                                                        meta={"by": "ref"})
        dst = port_scheduler(name, 99)
        assert PolicyZoo(str(tmp_path)).load_into("p", dst) == {"by": "ref"}
    assert_trees_equal(src.state_dict(), dst.state_dict())


def test_zoo_kind_mismatch_unknown_and_empty(tmp_path):
    zoo = PolicyZoo(str(tmp_path))
    assert zoo.names() == []
    zoo.save_scheduler("d", port_scheduler("dnn", 0))
    with pytest.raises(ValueError, match="kind"):
        zoo.load_into("d", port_scheduler("rlds", 0))
    with pytest.raises(FileNotFoundError, match="no policy 'nope'"):
        zoo.load_into("nope", port_scheduler("rlds", 0))
    with pytest.raises(FileNotFoundError, match="known: \\['d'\\]"):
        zoo.load("nope", like={})
    with pytest.raises(TypeError, match="empty state_dict"):
        zoo.load_into("d", port_scheduler("greedy", 0))
    assert zoo.names() == ["d"]
    assert zoo.info("d") == {"kind": "dnn", "meta": {}}


def test_zoo_kind_read_before_arrays(tmp_path, monkeypatch):
    """A kind mismatch is refused from the manifest alone: no array of the
    entry is loaded."""
    from repro_torch.gym import zoo as zoo_mod

    zoo = PolicyZoo(str(tmp_path))
    zoo.save_scheduler("b", port_scheduler("bods", 0))

    def no_load(*a, **k):
        raise AssertionError("arrays loaded")

    monkeypatch.setattr(zoo_mod, "load_checkpoint", no_load)
    with pytest.raises(ValueError, match="kind 'bods'"):
        zoo.load_into("b", port_scheduler("dnn", 0))


def test_save_rlds_params_matches_reference_tree(tmp_path):
    """The port's ``save_rlds_params`` writes the reference's tree: the same
    leaf paths, dtypes and shapes in the manifest (int32 step, f64
    baselines and adv_scale, bool pretrained), and the values equal."""
    ref_params = ref_rlds.init_policy(jax.random.PRNGKey(0))
    port_params = {k: torch.as_tensor(np.array(v))
                   for k, v in ref_params.items()}
    ref_gym.save_rlds_params(ref_gym.PolicyZoo(str(tmp_path / "r")), "p",
                             ref_params, num_jobs=3, meta={"x": 1})
    save_rlds_params(PolicyZoo(str(tmp_path / "t")), "p", port_params,
                     num_jobs=3, meta={"x": 1})

    def manifest(root):
        with open(tmp_path / root / "p" / "step_0000000000"
                  / "manifest.json") as f:
            return json.load(f)

    mr, mt = manifest("r"), manifest("t")
    for field in ("keys", "dtypes", "shapes", "extra"):
        assert mt[field] == mr[field], field
    dt = dict(zip(mt["keys"], mt["dtypes"]))
    assert dt["opt/.step"] == "int32" and dt["pretrained"] == "bool"
    assert dt["baselines"] == dt["adv_scale"] == "float64"
    ar = np.load(tmp_path / "r" / "p" / "step_0000000000" / "arrays.npz")
    at = np.load(tmp_path / "t" / "p" / "step_0000000000" / "arrays.npz")
    for i in range(len(mr["keys"])):
        np.testing.assert_array_equal(at[f"leaf_{i}"], ar[f"leaf_{i}"])


# ---- the policy axis -----------------------------------------------------

def twin_specs(scheduler, tmp_path, **replace):
    out = []
    for mod in (ref_presets, presets):
        spec = mod.get_preset("quickstart", scheduler=scheduler,
                              max_rounds=6, num_devices=40, n_jobs=2)
        out.append(spec.replace(scoring_backend="numpy", policy="p",
                                policy_dir=str(tmp_path), **replace))
    return out


def record_dicts(records):
    import dataclasses

    out = []
    for r in records:
        d = dataclasses.asdict(r)
        for key in ("device_ids", "dropped", "corrupt_ids", "failed_ids"):
            d[key] = np.asarray(d[key]).astype(int).tolist()
        out.append(d)
    return out


def ref_entry(kind, tmp_path, pool_size=40):
    """A reference-written zoo entry: a gym-trained RLDS policy, or a DNN
    or BODS scheduler driven on the quickstart pool's size."""
    zoo = ref_gym.PolicyZoo(str(tmp_path))
    if kind == "rlds":
        stages = ref_gym.default_stages("default", num_devices=(pool_size,),
                                        num_jobs=2)
        params, _ = ref_gym.train_rlds(
            stages, ref_gym.TrainConfig(num_envs=2, rollout_len=4, iters=2,
                                        minibatches=2), seed=0)
        ref_gym.save_rlds_params(zoo, "p", params, num_jobs=2,
                                 meta={"curriculum": "default"})
        return
    src = drive(ref_scheduler(kind, 3, pool_seed=1, num_devices=pool_size),
                RefCtx, rounds=4)
    zoo.save_scheduler("p", src)


def test_policy_axis_rlds_reference_entry_matches_reference(monkeypatch,
                                                            tmp_path):
    """``rlds-warmstart``'s path on a reference-written, gym-trained RLDS
    entry: the port's spec builds with the entry's params bit for bit and
    no lazy pretraining, and its records equal the reference's run of the
    same spec, unless a policy draw's Gumbel keys tie within 1e-5 at the
    n_sel boundary (then the records of the decisions before it)."""
    ref_entry("rlds", tmp_path)
    ref_spec, port_spec = twin_specs("rlds", tmp_path)
    assert ref_spec.to_dict() == port_spec.to_dict()
    ref_exp, port_exp = ref_spec.build(), port_spec.build(device="cpu")
    sched = port_exp.engine.scheduler
    assert sched._pretrained
    assert_trees_equal(sched.state_dict(),
                       ref_exp.engine.scheduler.state_dict())
    monkeypatch.setattr(rlds.RLDSScheduler, "_pretrain", lambda *a: (
        _ for _ in ()).throw(AssertionError("pretraining ran")))
    logs = {"ref": [], "port": []}
    keys = {"ref": [], "port": []}
    for mod, key in ((ref_rlds, "ref"), (rlds, "port")):
        schedule = mod.RLDSScheduler.schedule

        def keyed(s, ctx, _schedule=schedule, _keys=keys[key]):
            _keys.append((int(ctx.job), int(ctx.round_idx)))
            return _schedule(s, ctx)

        monkeypatch.setattr(mod.RLDSScheduler, "schedule", keyed)
        orig = mod.gumbel_topk_plans

        def logged(rng, logits, available, n_sel, _orig=orig, _log=logs[key]):
            state = copy.deepcopy(rng.bit_generator.state)
            out = _orig(rng, logits, available, n_sel)
            replay = np.random.Generator(type(rng.bit_generator)())
            replay.bit_generator.state = state
            lg = np.atleast_2d(np.asarray(logits, np.float64))
            _log.append((np.where(available[None], lg + replay.gumbel(
                size=lg.shape), -np.inf), out))
            return out

        monkeypatch.setattr(mod, "gumbel_topk_plans", logged)
    a = record_dicts(ref_exp.run().records)
    b = record_dicts(port_exp.run().records)
    assert len(logs["port"]) == len(b) > 0
    split = len(b)
    for i, ((ka, pa), (_, pb)) in enumerate(zip(logs["ref"], logs["port"])):
        if not np.array_equal(pa, pb):
            top = np.sort(ka[0])[::-1]
            n = int(pa[0].sum())
            assert top[n - 1] - top[n] <= NEAR_TIE * max(1.0, abs(top[n - 1]))
            split = i
            break
    if split == len(b):
        assert a == b
        return
    # records of the decisions both sides made alike, before the split
    before = set(keys["ref"][:split])
    assert keys["ref"][:split] == keys["port"][:split]
    assert ([r for r in a if (r["job"], r["round_idx"]) in before]
            == [r for r in b if (r["job"], r["round_idx"]) in before])


@pytest.mark.parametrize("kind", ["dnn", "bods"])
def test_policy_axis_dnn_bods_reference_entries(kind, monkeypatch, tmp_path):
    """DNN and BODS entries warm-start through the axis too: the state
    loads bit for bit and the run gives the reference's records (BODS on
    its host search; the reference's DNN steps waited for, as in
    test_torch_paper_schedulers.py)."""
    ref_entry(kind, tmp_path)
    extra = {"search_backend": "host"} if kind == "bods" else {}
    ref_spec, port_spec = twin_specs(kind, tmp_path, **extra)
    if kind == "dnn":
        step = ref_dnn._sgd_step
        monkeypatch.setattr(ref_dnn, "_sgd_step",
                            lambda *a: jax.block_until_ready(step(*a)))
    ref_exp, port_exp = ref_spec.build(), port_spec.build(device="cpu")
    assert_trees_equal(port_exp.engine.scheduler.state_dict(),
                       ref_exp.engine.scheduler.state_dict())
    a = record_dicts(ref_exp.run().records)
    b = record_dicts(port_exp.run().records)
    assert len(b) > 0
    assert a == b


def test_gym_trained_port_policy_loads_into_spec(tmp_path):
    """A port-trained policy saved to the zoo loads into spec.build()'s
    live scheduler by name, bit-exactly, with pretraining disabled."""
    stages = default_stages("default", num_devices=(30,), num_jobs=2)
    params, _ = train_rlds(stages, TrainConfig(num_envs=4, rollout_len=4,
                                               iters=2, minibatches=2),
                           seed=0, device="cpu")
    zoo = PolicyZoo(str(tmp_path))
    save_rlds_params(zoo, "gym-pol", params, num_jobs=2,
                     meta={"curriculum": "default"})
    spec = ExperimentSpec(
        jobs=tuple(JobSpec(name=f"j{i}", target_metric=0.7, max_rounds=3)
                   for i in range(2)),
        pool=PoolSpec(num_devices=30, seed=3), scheduler="rlds",
        runtime="synthetic", runtime_kwargs={"seed": 2}, n_sel=4,
        policy="gym-pol", policy_dir=str(tmp_path))
    exp = spec.build(device="cpu")
    sched = exp.engine.scheduler
    for k in params:
        assert torch.equal(sched.params[k], params[k])
    assert sched._pretrained and sched._pretrain_cfg[0] == 0
    assert len(exp.run().records) > 0


def test_policy_axis_json_roundtrip(tmp_path):
    spec = ExperimentSpec(jobs=(JobSpec(name="j"),), scheduler="rlds",
                          policy="some-policy", policy_dir=str(tmp_path))
    restored = ExperimentSpec.from_json(spec.to_json())
    assert restored == spec and restored.policy == "some-policy"
    ref = ref_spec_mod.ExperimentSpec.from_json(spec.to_json())
    assert ref.policy == "some-policy" and ref.policy_dir == str(tmp_path)


def test_rlds_warm_start_skips_pretraining():
    donor = port_scheduler("rlds", 1)
    sched = port_scheduler("rlds", 2, pretrain_rounds=300)
    assert not sched._pretrained
    sched.load_state_dict(donor.state_dict())
    assert sched._pretrained  # schedule() will never run the 300 rounds
    for k in donor.params:
        assert torch.equal(sched.params[k], donor.params[k])


def test_rlds_warmstart_preset_builds(tmp_path):
    """The registered ``rlds-warmstart`` preset builds and runs on a
    port-saved entry; without one it names the zoo's known entries."""
    spec = presets.get_preset("rlds-warmstart", policy="w",
                              policy_dir=str(tmp_path), max_rounds=2,
                              num_devices=30, n_jobs=2)
    with pytest.raises(FileNotFoundError, match="no policy 'w'"):
        spec.build(device="cpu")
    params = rlds.init_policy(torch.Generator().manual_seed(0))
    save_rlds_params(PolicyZoo(str(tmp_path)), "w", params, num_jobs=2)
    result = spec.run(device="cpu")
    assert len(result.records) == 4


# ---- the CLI --------------------------------------------------------------

def run_cli(*args, cwd):
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-m", "repro_torch.gym", *args],
                         env=env, cwd=cwd, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_cli_train_eval_list_on_cpu(tmp_path):
    zoo = str(tmp_path / "zoo")
    text = run_cli("train", "--name", "tiny", "--curriculum", "flaky",
                   "--num-devices", "24,30", "--num-jobs", "2", "--envs", "2",
                   "--rollout", "4", "--iters", "2", "--minibatches", "2",
                   "--zoo", zoo, "--device", "cpu", cwd=tmp_path)
    assert "trained mean_cost=" in text and "saved ->" in text
    info = PolicyZoo(zoo).info("tiny")
    assert info["kind"] == "rlds" and info["meta"]["num_devices"] == [24, 30]
    ev = json.loads(run_cli("eval", "--name", "tiny", "--num-devices", "24",
                            "--num-jobs", "2", "--zoo", zoo, "--device",
                            "cpu", cwd=tmp_path))
    assert np.isfinite(ev["eval"]["mean_cost"]) and ev["name"] == "tiny"
    assert "tiny" in run_cli("list", "--zoo", zoo, cwd=tmp_path)
    # the reference's CLI reads the port's entry
    from repro.gym import cli as ref_cli

    ref_cli.main(["list", "--zoo", zoo])
