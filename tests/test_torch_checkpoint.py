"""The port's checkpoints (``repro_torch.checkpoint``) against the
reference's ``repro.checkpoint``, on the CPU.

Both packages write the same layout (``step_<N>/manifest.json``,
``arrays.npz`` with leaves ``leaf_<i>``, ``.complete``) and visit leaves in
JAX's order, so each loads the other's step. The shared tree holds f32,
f64, int64, bool and bf16 leaves (an ``ml_dtypes`` array on the reference's
side, a torch tensor on the port's), a NamedTuple, a ``None`` and dicts
keyed ``"2"`` and ``"10"``. Tolerance: none; every leaf compares bit for
bit. Also: the port's own contracts (partial saves invisible, keep-last-N,
garbage collection, the fall-back past a corrupt newest step), tensor
leaves restored to the dtype and device of ``like``, and the tree helpers
against ``jax.tree_util``.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
ml_dtypes = pytest.importorskip("ml_dtypes")

from repro import checkpoint as ref_ckpt  # noqa: E402
from repro.optim.optimizers import OptState as RefOptState  # noqa: E402
from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch.optim.optimizers import OptState  # noqa: E402
from repro_torch.tree import (tree_flatten_with_paths, tree_leaves,  # noqa: E402
                              tree_map, tree_unflatten)

BF16 = np.array([1.5, -2.25, 3.0e-3, 65280.0], np.float32)


def ref_tree():
    rng = np.random.default_rng(0)
    return {
        "f32": rng.standard_normal((3, 4)).astype(np.float32),
        "f64": rng.standard_normal(5),
        "i64": np.arange(6, dtype=np.int64).reshape(2, 3),
        "bool": np.array([True, False, True]),
        "bf16": BF16.astype(ml_dtypes.bfloat16),
        "opt": RefOptState(np.asarray(7, np.int32),
                           (np.ones(2, np.float32), np.zeros(2, np.float32))),
        "none": None,
        "keys": {"2": np.float32(2.0), "10": np.float32(10.0)},
    }


def port_tree():
    """``ref_tree`` as the port holds it: tensors for bf16 and the
    optimizer state, numpy for the rest."""
    t = ref_tree()
    t["bf16"] = torch.from_numpy(BF16).to(torch.bfloat16)
    t["opt"] = OptState(torch.tensor(7, dtype=torch.int32),
                        (torch.ones(2), torch.zeros(2)))
    return t


def manifest(path, step):
    with open(os.path.join(path, f"step_{step:010d}", "manifest.json")) as f:
        return json.load(f)


def as_numpy(leaf):
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(np.uint16)
        return leaf.numpy()
    a = np.asarray(leaf)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def assert_leaves_equal(a, b):
    la, lb = tree_flatten_with_paths(a), tree_flatten_with_paths(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (key, x), (_, y) in zip(la, lb):
        x, y = as_numpy(x), as_numpy(y)
        assert x.dtype == y.dtype and x.shape == y.shape, key
        np.testing.assert_array_equal(x, y, err_msg=key)


# ---- the layout, both ways --------------------------------------------------

def test_manifests_agree(tmp_path):
    ref_ckpt.save_checkpoint(str(tmp_path / "ref"), 3, ref_tree(),
                             extra={"cursor": 1})
    ckpt.save_checkpoint(str(tmp_path / "port"), 3, port_tree(),
                         extra={"cursor": 1})
    a, b = manifest(tmp_path / "ref", 3), manifest(tmp_path / "port", 3)
    assert a == b
    assert "bfloat16" in a["dtypes"]
    assert "opt/.step" in a["keys"] and "keys/10" in a["keys"]
    assert sorted(os.listdir(tmp_path / "port" / "step_0000000003")) \
        == sorted(os.listdir(tmp_path / "ref" / "step_0000000003"))


def test_port_loads_reference_step(tmp_path):
    ref_ckpt.save_checkpoint(str(tmp_path), 5, ref_tree(), extra={"x": 2})
    step, restored, extra = ckpt.load_checkpoint(str(tmp_path), port_tree())
    assert (step, extra) == (5, {"x": 2})
    assert restored["bf16"].dtype == torch.bfloat16
    assert isinstance(restored["opt"], OptState)
    assert restored["opt"].step.dtype == torch.int32
    assert restored["none"] is None
    assert isinstance(restored["f64"], np.ndarray)
    assert_leaves_equal(restored, port_tree())


def test_reference_loads_port_step(tmp_path):
    ckpt.save_checkpoint(str(tmp_path), 5, port_tree(), extra={"x": 2})
    step, restored, extra = ref_ckpt.load_checkpoint(str(tmp_path),
                                                     ref_tree())
    assert (step, extra) == (5, {"x": 2})
    assert restored["bf16"].dtype == ml_dtypes.bfloat16
    assert_leaves_equal(restored, ref_tree())


def test_port_round_trip_without_ml_dtypes_leaves(tmp_path):
    """A bf16 tensor leaf comes back as a bf16 tensor with the same bits;
    an ml_dtypes ``like`` leaf gets an ml_dtypes array."""
    ckpt.save_checkpoint(str(tmp_path), 1, port_tree())
    _, restored, _ = ckpt.load_checkpoint(str(tmp_path), port_tree())
    assert_leaves_equal(restored, port_tree())
    _, as_ref, _ = ckpt.load_checkpoint(str(tmp_path), ref_tree())
    assert as_ref["bf16"].dtype == ml_dtypes.bfloat16
    assert_leaves_equal(as_ref, ref_tree())


@pytest.mark.parametrize("dtype", ["float8_e4m3fn", "float8_e5m2"])
def test_fp8_leaves_cross_both_ways(tmp_path, dtype):
    vals = np.array([0.5, -1.0, 2.0, 0.0], np.float32)
    ref = {"w": vals.astype(getattr(ml_dtypes, dtype))}
    port = {"w": torch.from_numpy(vals).to(getattr(torch, dtype))}
    ref_ckpt.save_checkpoint(str(tmp_path / "ref"), 1, ref)
    ckpt.save_checkpoint(str(tmp_path / "port"), 1, port)
    assert manifest(tmp_path / "ref", 1) == manifest(tmp_path / "port", 1)
    _, got, _ = ckpt.load_checkpoint(str(tmp_path / "ref"), port)
    assert got["w"].dtype == port["w"].dtype
    assert torch.equal(got["w"].view(torch.uint8), port["w"].view(torch.uint8))
    _, back, _ = ref_ckpt.load_checkpoint(str(tmp_path / "port"), ref)
    np.testing.assert_array_equal(back["w"].view(np.uint8),
                                  ref["w"].view(np.uint8))


def test_tensor_leaves_take_dtype_and_device_of_like(tmp_path):
    saved = {"a": np.arange(4, dtype=np.float64), "b": torch.ones(3)}
    ckpt.save_checkpoint(str(tmp_path), 1, saved)
    like = {"a": torch.zeros(4, dtype=torch.float32), "b": np.zeros(3)}
    _, got, _ = ckpt.load_checkpoint(str(tmp_path), like)
    assert got["a"].dtype == torch.float32 and got["a"].device.type == "cpu"
    assert isinstance(got["b"], np.ndarray) and got["b"].dtype == np.float64
    np.testing.assert_array_equal(got["a"].numpy(), np.arange(4))


def test_structure_mismatch_raises_not_falls_back(tmp_path):
    ckpt.save_checkpoint(str(tmp_path), 1, {"a": np.ones(2)})
    ckpt.save_checkpoint(str(tmp_path), 2, {"a": np.ones(2)})
    with pytest.raises(RuntimeError, match="structure mismatch"):
        ckpt.load_checkpoint(str(tmp_path), {"a": np.ones(2), "b": 1.0})


# ---- the port's own contracts (the reference's checkpoint suite) ----------

@pytest.fixture
def tree():
    return {"layer": {"w": torch.arange(12.0).reshape(3, 4),
                      "b": torch.ones(4, dtype=torch.bfloat16)},
            "opt": (np.zeros(3), np.asarray(7, np.int32))}


def test_roundtrip(tmp_path, tree):
    ckpt.save_checkpoint(str(tmp_path), 5, tree, extra={"cursor": 42})
    step, restored, extra = ckpt.load_checkpoint(str(tmp_path), tree)
    assert step == 5 and extra == {"cursor": 42}
    assert_leaves_equal(tree, restored)
    assert restored["layer"]["b"].dtype == torch.bfloat16


def test_partial_saves_invisible(tmp_path, tree):
    ckpt.save_checkpoint(str(tmp_path), 1, tree)
    os.makedirs(tmp_path / "step_0000000009")
    with open(tmp_path / "step_0000000009" / "manifest.json", "w") as f:
        f.write("{}")
    step, _, _ = ckpt.load_checkpoint(str(tmp_path), tree)
    assert step == 1
    assert ckpt.committed_steps(str(tmp_path)) == [1]


def test_manager_keeps_last_n(tmp_path, tree):
    mgr = ckpt.CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    assert sorted(os.listdir(tmp_path)) == ["step_0000000003",
                                           "step_0000000004"]
    assert mgr.latest_step() == 4


def test_manager_gc_partial_on_init(tmp_path, tree):
    ckpt.save_checkpoint(str(tmp_path), 1, tree)
    os.makedirs(tmp_path / ".tmp_step_9_abc")
    os.makedirs(tmp_path / "step_0000000009")
    ckpt.CheckpointManager(str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["step_0000000001"]


def test_restore_missing_raises(tmp_path, tree):
    with pytest.raises(FileNotFoundError):
        ckpt.load_checkpoint(str(tmp_path / "nope"), tree)


def test_manager_keep3_gc_under_repeated_saves(tmp_path, tree):
    mgr = ckpt.CheckpointManager(str(tmp_path), keep=3)
    for s in range(1, 9):
        mgr.save(s, tree)
        assert ckpt.committed_steps(str(tmp_path)) \
            == list(range(max(1, s - 2), s + 1))
    assert mgr.latest_step() == 8


def _corrupt(tmp_path, step, what):
    d = tmp_path / f"step_{step:010d}"
    if what == "arrays":
        with open(d / "arrays.npz", "wb") as f:
            f.write(b"not a zipfile")
    elif what == "manifest":
        with open(d / "manifest.json", "w") as f:
            f.write('{"step": ')
    else:
        os.remove(d / "arrays.npz")


@pytest.mark.parametrize("what", ["arrays", "manifest", "missing"])
def test_restore_falls_back_past_corrupt_latest(tmp_path, tree, what):
    ckpt.save_checkpoint(str(tmp_path), 1, tree, extra={"cursor": 1})
    ckpt.save_checkpoint(str(tmp_path), 2, tree, extra={"cursor": 2})
    _corrupt(tmp_path, 2, what)
    with pytest.warns(UserWarning, match="unreadable"):
        step, restored, extra = ckpt.load_checkpoint(str(tmp_path), tree)
    assert step == 1 and extra == {"cursor": 1}
    assert_leaves_equal(tree, restored)


def test_restore_explicit_corrupt_step_still_raises(tmp_path, tree):
    ckpt.save_checkpoint(str(tmp_path), 1, tree)
    ckpt.save_checkpoint(str(tmp_path), 2, tree)
    _corrupt(tmp_path, 2, "arrays")
    with pytest.raises(Exception):
        ckpt.load_checkpoint(str(tmp_path), tree, step=2)


def test_restore_all_corrupt_raises(tmp_path, tree):
    ckpt.save_checkpoint(str(tmp_path), 1, tree)
    ckpt.save_checkpoint(str(tmp_path), 2, tree)
    _corrupt(tmp_path, 1, "manifest")
    _corrupt(tmp_path, 2, "arrays")
    with pytest.warns(UserWarning), pytest.raises(FileNotFoundError,
                                                  match="unreadable"):
        ckpt.load_checkpoint(str(tmp_path), tree)


def test_rlds_state_round_trips_through_a_checkpoint(tmp_path):
    """RLDS's params and ``OptState`` are tensors: saved from the host,
    restored onto the device of the live state, and the restored learner
    makes the same next decision."""
    from repro_torch.core.cost import CostModel
    from repro_torch.core.devices import DevicePool
    from repro_torch.core.schedulers import get_scheduler
    from repro_torch.core.schedulers.base import SchedulingContext

    pool = DevicePool.heterogeneous(24, 2, seed=5)
    cm = CostModel(pool, alpha=4.0, beta=0.25, device="cpu")
    cm.calibrate([5.0, 5.0], n_sel=4)

    def ctx(r):
        return SchedulingContext(
            job=0, round_idx=r, tau=5.0, n_sel=4,
            available=np.ones(24, dtype=bool), counts=np.zeros(24),
            expected_times=pool.expected_times(0, 5.0))

    a = get_scheduler("rlds", cost_model=cm, seed=0, pretrain_rounds=0)
    for r in range(3):
        plan = a.schedule(ctx(r))
        a.observe(ctx(r), plan, 1.0 + r)
    ckpt.save_checkpoint(str(tmp_path), 1, a.state_dict())
    b = get_scheduler("rlds", cost_model=cm, seed=0, pretrain_rounds=0)
    _, state, _ = ckpt.load_checkpoint(str(tmp_path), b.state_dict())
    assert isinstance(state["opt"], OptState)
    b.load_state_dict(state)
    b.rng.bit_generator.state = a.rng.bit_generator.state
    assert_leaves_equal(a.state_dict(), b.state_dict())
    np.testing.assert_array_equal(a.schedule(ctx(3)), b.schedule(ctx(3)))


# ---- the tree helpers against jax.tree_util --------------------------------

def jax_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [("/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                      for p in path), leaf) for path, leaf in flat]


@pytest.mark.parametrize("tree", [
    {"b": 1, "a": [2, None, (3, {"z": 4, "y": None})], "10": 5, "2": 6},
    RefOptState(1, {"m": (2, 3), "v": []}),
    [None, {}, (), [7]],
    None,
    8,
], ids=["nested", "namedtuple", "empties", "none", "leaf"])
def test_flatten_with_paths_matches_jax(tree):
    assert tree_flatten_with_paths(tree) == jax_paths(tree)
    assert tree_leaves(tree) == jax.tree_util.tree_leaves(tree)
    n = len(tree_leaves(tree))
    rebuilt = tree_unflatten(tree, list(range(100, 100 + n)))
    assert rebuilt == jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(tree), list(range(100, 100 + n)))
    assert tree_map(lambda x: x, tree) == tree
