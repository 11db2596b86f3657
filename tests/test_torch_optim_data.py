"""The host pieces of the port's LM train path against the reference's on
the CPU: ``adafactor`` and ``make_optimizer`` (``repro/optim``), the
learning-rate schedules, ``Batcher`` and ``host_local_batches``
(``repro/data/pipeline.py``), ``make_lm_tokens``, ``TokenBatcher``
(``repro/launch/train.py``), ``run_elastic`` (``repro/launch/elastic.py``)
and the optimizer-state converters, mirroring tests/test_optim.py,
tests/test_data.py and tests/test_elastic.py.

Tolerances: optimizer updates and states within OPT_TOL = 1e-6 relative
plus absolute (float32, the same formulas summed in another order);
schedules within SCHED_TOL = 1e-7; the numpy pieces (tokens, batches,
permutations) bit for bit. A training checkpoint crosses between the
packages both ways, and the step after the resume agrees with the other
package's within STEP_RTOL = 1e-4 (the same limit as
tests/test_torch_train.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import CheckpointManager as RefCheckpointManager  # noqa: E402
from repro.config.base import OptimizerConfig as RefOptimizerConfig  # noqa: E402
from repro.config.base import ShapeConfig as RefShapeConfig  # noqa: E402
from repro.config.base import TrainConfig as RefTrainConfig  # noqa: E402
from repro.configs import qwen3_1p7b as ref_qwen  # noqa: E402
from repro.data import pipeline as ref_pipeline  # noqa: E402
from repro.data import synthetic as ref_synth  # noqa: E402
from repro.launch import elastic as ref_elastic  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.launch import train as ref_train  # noqa: E402
from repro.models import transformer as rt  # noqa: E402
from repro.optim import optimizers as ref_opt  # noqa: E402
from repro.optim import schedule as ref_sched  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.config.base import (FLConfig, OptimizerConfig,  # noqa: E402
                                     ShapeConfig, TrainConfig)
from repro_torch.configs import qwen3_1p7b  # noqa: E402
from repro_torch.data import pipeline, synthetic  # noqa: E402
from repro_torch.launch import elastic  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402
from repro_torch.models import transformer as pt  # noqa: E402
from repro_torch.optim import (adafactor, make_optimizer,  # noqa: E402
                               schedule)
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

OPT_TOL = 1e-6
SCHED_TOL = 1e-7
STEP_RTOL = 1e-4
OPT_NAMES = ("sgd", "momentum", "adam", "adamw", "adafactor")


def random_tree(seed):
    """A tree with a 3-d, a 2-d and a 1-d leaf (numpy float32)."""
    rng = np.random.default_rng(seed)
    return {"blocks": {"w": rng.normal(0, 1, (2, 6, 5)).astype(np.float32),
                       "b": rng.normal(0, 1, (7,)).astype(np.float32)},
            "head": rng.normal(0, 1, (4, 3)).astype(np.float32)}


def to_torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def assert_close(ref_tree, port_tree, tol):
    ref_leaves = jax.tree_util.tree_leaves(ref_tree)
    leaves = tree_leaves(port_tree)
    assert len(ref_leaves) == len(leaves)
    for a, b in zip(ref_leaves, leaves):
        a = np.asarray(a, np.float64)
        b = b.double().numpy()
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=tol, atol=tol)


def run_opt(ref_pair, pair, n_steps=4):
    """``n_steps`` updates of both optimizers on the same params and
    gradients; the params move by the updates."""
    (rinit, rupdate), (init, update) = ref_pair, pair
    rp = jax.tree_util.tree_map(jnp.asarray, random_tree(0))
    p = to_torch(random_tree(0))
    rs, s = rinit(rp), init(p)
    for i in range(n_steps):
        g = random_tree(10 + i)
        ru, rs = rupdate(jax.tree_util.tree_map(jnp.asarray, g), rs, rp)
        u, s = update(to_torch(g), s, p)
        assert_close(ru, u, OPT_TOL)
        rp = jax.tree_util.tree_map(lambda a, b: a + b, rp, ru)
        p = tree_map(lambda a, b: a + b, p, u)
    assert int(s.step) == int(rs.step) == n_steps
    assert_close(rs.inner, s.inner, OPT_TOL)
    assert_close(rp, p, OPT_TOL)
    return rs, s


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
@pytest.mark.parametrize("lr", [1e-3, 0.5])
def test_adafactor_matches_reference(lr, weight_decay):
    rs, s = run_opt(ref_opt.adafactor(lr, weight_decay=weight_decay),
                    adafactor(lr, weight_decay=weight_decay))
    row, col = s.inner["blocks"]["w"]
    assert tuple(row.shape) == (2, 6) and tuple(col.shape) == (2, 5)
    full, none = s.inner["blocks"]["b"]
    assert tuple(full.shape) == (7,) and none is None
    assert rs.inner["blocks"]["b"][1] is None


def test_adafactor_state_is_factored():
    init, _ = adafactor(0.1)
    st = init({"w": torch.zeros((64, 32))})
    row, col = st.inner["w"]
    assert tuple(row.shape) == (64,) and tuple(col.shape) == (32,)
    assert row.dtype == col.dtype == torch.float32
    assert st.step.dtype == torch.int32


@pytest.mark.parametrize("name", OPT_NAMES)
def test_make_optimizer_matches_reference(name):
    kw = dict(name=name, lr=0.05, weight_decay=0.01)
    run_opt(ref_opt.make_optimizer(RefOptimizerConfig(**kw)),
            make_optimizer(OptimizerConfig(**kw)))


def test_make_optimizer_rejects_unknown():
    with pytest.raises(KeyError, match="lion"):
        make_optimizer(OptimizerConfig(name="lion"))


def test_configs_match_reference():
    from repro.config import base as ref_base

    for ours, theirs in ((OptimizerConfig, ref_base.OptimizerConfig),
                         (TrainConfig, ref_base.TrainConfig),
                         (FLConfig, ref_base.FLConfig)):
        assert [f.name for f in dataclasses.fields(ours)] == [
            f.name for f in dataclasses.fields(theirs)]
        a, b = dataclasses.asdict(ours()), dataclasses.asdict(theirs())
        assert a == b


@pytest.mark.parametrize("kind", ["cosine", "warmup_cosine"])
def test_schedules_match_reference(kind):
    if kind == "cosine":
        ref_fn, fn = ref_sched.cosine_schedule(40), schedule.cosine_schedule(40)
    else:
        ref_fn = ref_sched.warmup_cosine(10, 45)
        fn = schedule.warmup_cosine(10, 45)
    for step in range(50):
        exp = float(ref_fn(jnp.asarray(step, jnp.int32)))
        got = fn(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert abs(float(got) - exp) <= SCHED_TOL


def test_schedules_shape():
    cos = schedule.cosine_schedule(100)
    assert float(cos(0)) == pytest.approx(1.0)
    assert float(cos(100)) == pytest.approx(0.1, abs=1e-6)
    wc = schedule.warmup_cosine(10, 110)
    assert float(wc(5)) == pytest.approx(0.5)
    assert float(wc(10)) == pytest.approx(1.0)


def test_make_lm_tokens_bit_exact():
    exp = ref_synth.make_lm_tokens(5000, 97, seed=3)
    got = synthetic.make_lm_tokens(5000, 97, seed=3)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, exp)


def test_batcher_state_restore_bit_exact():
    x = np.arange(50, dtype=np.float32)[:, None] * np.ones((1, 3), np.float32)
    y = np.arange(50, dtype=np.int32)
    ref_b = ref_pipeline.Batcher(x, y, batch_size=8, seed=4)
    b = pipeline.Batcher(x, y, batch_size=8, seed=4)
    for _ in range(9):  # past an epoch boundary
        (rx, ry), (px, py) = next(ref_b), next(b)
        np.testing.assert_array_equal(rx, px)
        np.testing.assert_array_equal(ry, py)
    assert b.state() == ref_b.state()
    saved = b.state()
    ahead = [next(b) for _ in range(4)]
    fresh = pipeline.Batcher(x, y, batch_size=8, seed=0)
    fresh.restore(saved)
    ref_b.restore(saved)
    for (ax, ay) in ahead:
        (fx, fy), (rx, _) = next(fresh), next(ref_b)
        np.testing.assert_array_equal(fx, ax)
        np.testing.assert_array_equal(fy, ay)
        np.testing.assert_array_equal(rx, ax)


@pytest.mark.parametrize("host_id,num_hosts", [(0, 1), (1, 4), (3, 4)])
def test_host_local_batches(host_id, num_hosts):
    g = np.arange(24 * 3).reshape(24, 3)
    np.testing.assert_array_equal(
        pipeline.host_local_batches(g, host_id, num_hosts),
        ref_pipeline.host_local_batches(g, host_id, num_hosts))


def test_token_batcher_bit_exact_and_restartable():
    ref_cfg, cfg = ref_qwen.reduced(), qwen3_1p7b.reduced()
    ref_tb = ref_train.TokenBatcher(ref_cfg, 4, 32, seed=1)
    tb = port_train.TokenBatcher(cfg, 4, 32, seed=1, device="cpu")
    np.testing.assert_array_equal(tb.tokens, ref_tb.tokens)
    for _ in range(3):
        rb, pb = next(ref_tb), next(tb)
        assert sorted(rb) == sorted(pb) == ["labels", "tokens"]
        for k in rb:
            assert pb[k].dtype == torch.int32
            np.testing.assert_array_equal(np.asarray(rb[k]), pb[k].numpy())
    assert tb.state() == ref_tb.state()
    saved = tb.state()
    nxt = next(tb)["tokens"]
    tb.restore(saved)
    assert torch.equal(next(tb)["tokens"], nxt)
    tb.cursor = len(tb.tokens) - 10      # wraps to the start, as the reference
    ref_tb.cursor = tb.cursor
    np.testing.assert_array_equal(np.asarray(next(ref_tb)["tokens"]),
                                  next(tb)["tokens"].numpy())


# ---- run_elastic (tests/test_elastic.py's four behaviours) ----

class CountingBatcher:
    """Deterministic restartable stream of scalar 'batches'."""

    def __init__(self):
        self.cursor = 0

    def state(self):
        return {"cursor": self.cursor}

    def restore(self, st):
        self.cursor = st["cursor"]

    def __next__(self):
        self.cursor += 1
        return torch.tensor(float(self.cursor), dtype=torch.float64)


def _step(state, batch):
    return state + batch, {"loss": batch}


def zero():
    return torch.tensor(0.0, dtype=torch.float64)


@pytest.mark.parametrize("fail_at,num_steps,save_every,restarts", [
    ((), 30, 10, 0), ((17, 23), 30, 10, 2), ((3,), 12, 10, 1)])
def test_run_elastic_recovers_the_exact_state(tmp_path, fail_at, num_steps,
                                               save_every, restarts):
    inj = elastic.FailureInjector(fail_at_steps=fail_at)
    out = elastic.run_elastic(
        make_state=zero, step_fn=_step, batch_iter=CountingBatcher(),
        num_steps=num_steps,
        config=elastic.ElasticConfig(save_every=save_every,
                                     checkpoint_dir=str(tmp_path)),
        injector=inj)
    assert out["restarts"] == restarts
    assert inj.injected == list(fail_at)
    assert float(out["state"]) == sum(range(1, num_steps + 1))
    assert (out["steps_replayed"] > 0) == bool(fail_at)


def test_run_elastic_exceeding_max_restarts_raises(tmp_path):
    inj = elastic.FailureInjector(fail_at_steps=[2, 3, 4, 5, 6])
    with pytest.raises(RuntimeError, match="max_restarts=3"):
        elastic.run_elastic(
            make_state=zero, step_fn=_step, batch_iter=CountingBatcher(),
            num_steps=10,
            config=elastic.ElasticConfig(save_every=100,
                                         checkpoint_dir=str(tmp_path),
                                         max_restarts=3),
            injector=inj)


# ---- training state across the packages ----

@pytest.mark.parametrize("name", ["sgd", "momentum", "adamw", "adafactor"])
def test_lm_opt_state_converts_both_ways(name):
    cfg = dataclasses.replace(ref_qwen.reduced(), dtype="float32")
    params, _ = rt.lm_init(cfg, 0)
    init, update = ref_opt.make_optimizer(RefOptimizerConfig(name=name))
    ref_state = init(params)
    grads = jax.tree_util.tree_map(lambda p: jnp.ones_like(p) * 0.01, params)
    _, ref_state = update(grads, ref_state, params)
    host = jax.device_get(ref_state)
    got = convert.lm_opt_state_from_reference(host, device="cpu")
    assert got.step.dtype == torch.int32 and int(got.step) == 1
    ref_leaves = jax.tree_util.tree_leaves(host)
    leaves = tree_leaves(got)
    assert len(ref_leaves) == len(leaves)
    for a, b in zip(ref_leaves, leaves):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    back = convert.lm_opt_state_to_reference(got)
    assert jax.tree_util.tree_structure(back.inner) == \
        jax.tree_util.tree_structure(host.inner)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(host)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # the reference's optimizer takes the converted state back
    update(grads, back, params)


def ref_run(cfg, ckpt, num_steps, save_every):
    """The reference's run_elastic over synth_batch batches, AdamW."""
    step, opt_init = ref_steps.make_train_step(cfg, RefTrainConfig(
        optimizer=RefOptimizerConfig(name="adamw")))
    step = jax.jit(step)

    def make_state():
        p, _ = rt.lm_init(cfg, 0)
        return (p, opt_init(p))

    def step_fn(state, batch):
        p, o, m = step(*state, batch)
        return (p, o), m

    return ref_elastic.run_elastic(
        make_state=make_state, step_fn=step_fn,
        batch_iter=SynthBatches(lambda s: ref_steps.synth_batch(
            cfg, RefShapeConfig("t", 16, 2, "train"), seed=s)),
        num_steps=num_steps,
        config=ref_elastic.ElasticConfig(save_every=save_every,
                                         checkpoint_dir=str(ckpt)))


def port_run(cfg, ckpt, num_steps, save_every):
    step, opt_init = steps.make_train_step(cfg, TrainConfig(
        optimizer=OptimizerConfig(name="adamw")))

    def make_state():
        p = pt.lm_init(cfg, 0, device="cpu")
        return (p, opt_init(p))

    def step_fn(state, batch):
        p, o, m = step(*state, batch)
        return (p, o), m

    return elastic.run_elastic(
        make_state=make_state, step_fn=step_fn,
        batch_iter=SynthBatches(lambda s: steps.synth_batch(
            cfg, ShapeConfig("t", 16, 2, "train"), seed=s, device="cpu")),
        num_steps=num_steps,
        config=elastic.ElasticConfig(save_every=save_every,
                                     checkpoint_dir=str(ckpt)))


class SynthBatches:
    """Batch i is synth_batch at seed i; the cursor rides in checkpoints."""

    def __init__(self, make):
        self.make, self.cursor = make, 0

    def state(self):
        return {"cursor": self.cursor}

    def restore(self, st):
        self.cursor = st["cursor"]

    def __next__(self):
        self.cursor += 1
        return self.make(self.cursor)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_resumes_in_the_other_package(tmp_path, writer):
    """One package trains 3 steps and checkpoints ``(params, adamw
    state)``; the other resumes from that directory for a 4th step, which
    agrees with the writer's own 4th step."""
    ref_cfg = dataclasses.replace(ref_qwen.reduced(), dtype="float32")
    cfg = dataclasses.replace(qwen3_1p7b.reduced(), dtype="float32")
    runs = {"reference": lambda d, n: ref_run(ref_cfg, d, n, 3),
            "port": lambda d, n: port_run(cfg, d, n, 3)}
    reader = "port" if writer == "reference" else "reference"
    runs[writer](tmp_path / "shared", 3)
    resumed = runs[reader](tmp_path / "shared", 4)
    own = runs[writer](tmp_path / "own", 4)
    assert resumed["restarts"] == own["restarts"] == 0
    ref_state = (own if writer == "reference" else resumed)["state"]
    port_state = (resumed if writer == "reference" else own)["state"]
    ref_leaves = jax.tree_util.tree_leaves(ref_state)
    leaves = tree_leaves(port_state)
    assert len(ref_leaves) == len(leaves)
    for a, b in zip(ref_leaves, leaves):
        a = np.asarray(a, np.float64)
        b = b.double().numpy() if isinstance(b, torch.Tensor) else np.asarray(
            b, np.float64)
        assert np.all(np.abs(a - b) <= STEP_RTOL * (1 + np.abs(a)))
    # the resumed run took exactly one step from the other's step 3
    assert int(tree_leaves(port_state[1])[0]) == 4
    mgr = (CheckpointManager if reader == "port" else RefCheckpointManager)(
        str(tmp_path / "shared"))
    assert mgr.latest_step() == 4
