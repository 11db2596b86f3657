"""The port's federated substrate against the reference's on the CPU:
synthetic data and partitions (bit-identical: pure numpy), the
scatter-add's plain version, FedAvg (plain, robust, compressed), top-k
compression and local SGD.

Tolerances, each with its reason:
- scatter-add, compressed FedAvg: 1e-5 relative plus absolute, as
  ``tests/test_fl.py`` holds the reference's own paths to each other (float32
  sums in another order);
- FedAvg, robust FedAvg: 1e-6 absolute (one weighted float32 sum over a few
  devices);
- local SGD: 1e-5 relative to the largest parameter (float32 matmuls summed
  in another order, carried through a few SGD steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.paper_models import cnn_b as ref_cnn_b  # noqa: E402
from repro.data import synthetic as ref_synthetic  # noqa: E402
from repro.fl import aggregation as ref_agg  # noqa: E402
from repro.fl import partition as ref_partition  # noqa: E402
from repro.fl import runtime as ref_runtime  # noqa: E402
from repro.kernels import ref as ref_oracle  # noqa: E402
from repro.kernels.scatter_add import scatter_add as ref_pallas  # noqa: E402
from repro.models.cnn_zoo import cnn_init as ref_cnn_init  # noqa: E402
from repro.optim import compression as ref_comp  # noqa: E402
from repro_torch.configs.paper_models import cnn_b  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.fl import aggregation as agg  # noqa: E402
from repro_torch.fl import partition  # noqa: E402
from repro_torch.fl import runtime  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import scatter_add as sa  # noqa: E402
from repro_torch.models.cnn_zoo import cnn_init  # noqa: E402
from repro_torch.optim import compression  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs several test files at once, and
    the timing-sensitive tests of other files must not be starved."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def t(a):
    return torch.from_numpy(np.asarray(a))


def assert_trees_close(ref_tree, port_tree, **tol):
    ref = jax.tree_util.tree_leaves(ref_tree)
    port = tree_leaves(port_tree)
    assert len(ref) == len(port)
    for a, b in zip(ref, port):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **tol)


# ---- data and partitions: bit-identical ----

@pytest.mark.parametrize("shape,classes,noise,seed", [
    ((28, 28, 1), 10, 1.2, 0), ((32, 32, 3), 10, 1.0, 101),
    ((8, 8, 1), 26, 0.5, 7)])
def test_classification_dataset_bit_identical(shape, classes, noise, seed):
    a = ref_synthetic.make_classification_dataset(300, shape, classes,
                                                  noise=noise, seed=seed)
    b = synthetic.make_classification_dataset(300, shape, classes,
                                              noise=noise, seed=seed)
    for u, v in zip(a, b):
        assert u.dtype == v.dtype
        np.testing.assert_array_equal(u, v)


def test_partitions_bit_identical():
    _, y = ref_synthetic.make_classification_dataset(2000, (4, 4, 1), 10,
                                                     seed=3)
    np.testing.assert_array_equal(
        ref_partition.noniid_partition(y, 37, seed=4),
        partition.noniid_partition(y, 37, seed=4))
    np.testing.assert_array_equal(
        ref_partition.iid_partition(y, 25, 40, seed=5),
        partition.iid_partition(y, 25, 40, seed=5))
    part = partition.noniid_partition(y, 37, seed=4)
    np.testing.assert_array_equal(
        ref_partition.device_label_histogram(y, part, 10),
        partition.device_label_histogram(y, part, 10))
    with pytest.raises(ValueError, match="width 0"):
        partition.noniid_partition(y[:30], 5, seed=0)


# ---- the scatter-add's plain version ----

SCATTER_CASES = [(3, 17, 64), (8, 32, 300), (1, 5, 1000), (16, 64, 4096)]


@pytest.mark.parametrize("n,k,size", SCATTER_CASES)
def test_scatter_add_matches_pallas_interpret_and_oracle(n, k, size):
    """The cases of tests/test_kernels_scatter.py: ragged sizes, repeats
    within and across rows. The wrapper on CPU tensors is the plain
    version."""
    rng = np.random.default_rng(n * 1000 + k)
    vals = rng.normal(0, 1, (n, k)).astype(np.float32)
    idx = rng.integers(0, size, (n, k)).astype(np.int32)
    w = rng.uniform(0.1, 2.0, (n,)).astype(np.float32)
    pallas = np.asarray(ref_pallas(jnp.asarray(vals), jnp.asarray(idx),
                                   jnp.asarray(w), size, block_s=128,
                                   block_k=128, interpret=True))
    oracle = np.asarray(ref_oracle.scatter_add(
        jnp.asarray(vals), jnp.asarray(idx), jnp.asarray(w), size))
    before = sa.launches
    for got in (sa.scatter_add_ref(t(vals), t(idx), t(w), size),
                sa.scatter_add(t(vals), t(idx).long(), t(w), size),
                ops.scatter_add(t(vals), t(idx), t(w), size, impl="cuda")):
        np.testing.assert_allclose(got.numpy(), pallas, **TOL)
        np.testing.assert_allclose(got.numpy(), oracle, **TOL)
    assert sa.launches == before  # CPU tensors never launch


def test_scatter_add_padding_and_out_of_range():
    vals = np.asarray([[1.0, 2.0, 3.0, 4.0]], np.float32)
    idx = np.asarray([[0, -1, 2, 4]], np.int32)   # -1 padding, 4 == size
    w = np.asarray([2.0], np.float32)
    got = sa.scatter_add(t(vals), t(idx), t(w), 4).numpy()
    np.testing.assert_allclose(got, [2.0, 0.0, 6.0, 0.0], atol=1e-6)
    pad_only = np.where(idx == 4, -1, idx)
    oracle = np.asarray(ref_oracle.scatter_add(
        jnp.asarray(vals), jnp.asarray(pad_only), jnp.asarray(w), 4))
    np.testing.assert_allclose(got, oracle, atol=1e-6)
    pallas = np.asarray(ref_pallas(jnp.asarray(vals), jnp.asarray(pad_only),
                                   jnp.asarray(w), 4, interpret=True))
    np.testing.assert_allclose(got, pallas, atol=1e-6)


def test_scatter_add_all_collisions():
    rng = np.random.default_rng(7)
    vals = rng.normal(0, 1, (4, 9)).astype(np.float32)
    idx = np.zeros((4, 9), np.int64)
    w = rng.uniform(0.5, 1.5, (4,)).astype(np.float32)
    got = sa.scatter_add(t(vals), t(idx), t(w), 16).numpy()
    pallas = np.asarray(ref_pallas(jnp.asarray(vals), jnp.asarray(idx),
                                   jnp.asarray(w), 16, interpret=True))
    np.testing.assert_allclose(got, pallas, **TOL)
    assert abs(got[0] - float((vals * w[:, None]).sum())) < 1e-4
    np.testing.assert_array_equal(got[1:], 0.0)


def test_scatter_add_rejects_bad_inputs():
    vals, idx, w = torch.ones(2, 3), torch.zeros(2, 3).long(), torch.ones(2)
    with pytest.raises(TypeError):
        sa.scatter_add(vals.double(), idx, w, 4)
    with pytest.raises(TypeError):
        sa.scatter_add(vals, idx.float(), w, 4)
    with pytest.raises(TypeError):
        sa.scatter_add(vals, idx, torch.ones(3), 4)
    with pytest.raises(ValueError):
        sa.scatter_add(vals, idx, w, 0)
    with pytest.raises(ValueError):
        ops.scatter_add(vals, idx, w, 4, impl="pallas")


# ---- FedAvg: plain, robust, compressed ----

def random_stack(rng, n_dev):
    """Multi-leaf CNN-shaped params and a device-stacked perturbation of
    them, as numpy (fed to both packages)."""
    g = [{"w": rng.normal(0, 1, (5, 5, 1, 4)).astype(np.float32),
          "b": rng.normal(0, 1, (4,)).astype(np.float32)},
         {"w": rng.normal(0, 1, (36, 10)).astype(np.float32),
          "b": rng.normal(0, 1, (10,)).astype(np.float32)}]
    stacked = [{k: np.stack([v + 0.1 * rng.normal(0, 1, v.shape)
                             for _ in range(n_dev)]).astype(np.float32)
                for k, v in layer.items()} for layer in g]
    return g, stacked


def jx(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def th(tree):
    return tree_map(t, tree)


def test_fedavg_matches_reference():
    rng = np.random.default_rng(0)
    g, stacked = random_stack(rng, 4)
    w = np.asarray([1.0, 0.0, 2.0, 3.0], np.float32)  # a zero-weight lane
    assert_trees_close(ref_agg.fedavg(jx(stacked), jnp.asarray(w)),
                       agg.fedavg(th(stacked), t(w)), atol=1e-6)
    out = agg.fedavg({"w": torch.tensor([[1.0, 2.0], [3.0, 4.0],
                                         [5.0, 6.0]])},
                     torch.tensor([1.0, 1.0, 2.0]))
    np.testing.assert_allclose(out["w"].numpy(), [14 / 4, 18 / 4])


def corrupted(rng, n_dev, nan_lane=1, blown_lane=3):
    g, stacked = random_stack(rng, n_dev)
    stacked[0]["w"][nan_lane] = np.nan
    stacked[1]["w"][blown_lane] *= 50.0
    return g, stacked


@pytest.mark.parametrize("mult", [4.0, 0.5])
def test_rejection_masks_match_reference(mult):
    g, stacked = corrupted(np.random.default_rng(1), 6)
    w = np.asarray([1.0, 1.0, 2.0, 1.0, 0.0, 3.0], np.float32)
    ref_jit = np.asarray(ref_agg.rejection_mask(jx(g), jx(stacked),
                                                jnp.asarray(w),
                                                jnp.float32(mult)))
    ref_host = ref_agg.rejection_mask_host(g, stacked, w, mult)
    got = agg.rejection_mask(th(g), th(stacked), t(w), mult).numpy()
    got_host = agg.rejection_mask_host(th(g), th(stacked), t(w), mult)
    np.testing.assert_array_equal(got, ref_jit)
    np.testing.assert_array_equal(got_host, ref_host)
    np.testing.assert_array_equal(got, got_host)
    assert not got[1] and not got[3] and not got[4]  # NaN, blown, weight 0


@pytest.mark.parametrize("case", ["mixed", "all-rejected", "median-of-one"])
def test_robust_fedavg_matches_reference(case):
    rng = np.random.default_rng(2)
    g, stacked = corrupted(rng, 4)
    w = np.asarray([1.0, 2.0, 1.0, 1.0], np.float32)
    if case == "all-rejected":
        for layer in stacked:
            layer["b"][:] = np.nan
    elif case == "median-of-one":
        w = np.asarray([0.0, 0.0, 1.0, 0.0], np.float32)
    ref_new, ref_ok = ref_agg.robust_fedavg(jx(g), jx(stacked),
                                            jnp.asarray(w), jnp.float32(0.5))
    new, ok = agg.robust_fedavg(th(g), th(stacked), t(w), 0.5)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ref_ok))
    assert_trees_close(ref_new, new, atol=1e-6)
    if case == "all-rejected":
        assert not ok.any()
        assert_trees_close(jx(g), new, atol=0)  # previous globals kept
    if case == "median-of-one":
        assert ok.tolist() == [False, False, True, False]


@pytest.mark.parametrize("ratio", [0.1, 0.33, 1.0])
def test_fedavg_compressed_matches_reference(ratio):
    rng = np.random.default_rng(3)
    g, stacked = random_stack(rng, 5)
    w = rng.uniform(0.5, 2.0, 5).astype(np.float32)
    port = {impl: agg.fedavg_compressed(th(g), th(stacked), t(w), ratio,
                                        impl=impl)
            for impl in ("ref", "cuda")}
    # The Pallas kernel in interpret mode is slow on the CPU: one ratio.
    for ref_impl in ("ref", "interpret") if ratio == 0.33 else ("ref",):
        ref = ref_agg.fedavg_compressed(jx(g), jx(stacked), jnp.asarray(w),
                                        ratio, impl=ref_impl)
        for out in port.values():
            assert_trees_close(ref, out, **TOL)
    loop = agg.fedavg_compressed_loop(th(g), th(stacked), t(w), ratio)
    for a, b in zip(tree_leaves(loop), tree_leaves(port["cuda"])):
        np.testing.assert_allclose(b.numpy(), a.numpy(), **TOL)
    if ratio == 1.0:
        assert_trees_close(ref_agg.fedavg(jx(stacked), jnp.asarray(w)),
                           port["cuda"], atol=1e-5)


@pytest.mark.parametrize("ratio,size,k", [
    (0.5, 5, 2), (0.5, 7, 4), (0.25, 10, 2), (0.1, 25, 2), (0.001, 10, 1),
    (1.0, 9, 9)])
def test_topk_count_rounds_half_to_even(ratio, size, k):
    """Python's round: 2.5 -> 2 and 3.5 -> 4, as the reference's k."""
    assert compression.topk_count(ratio, size) == k
    x = np.arange(1, size + 1, dtype=np.float32) * np.where(
        np.arange(size) % 2, -1.0, 1.0).astype(np.float32)
    (ref_vals, _), _ = ref_comp.topk_compress({"x": jnp.asarray(x)}, ratio)
    (vals, idx), _ = compression.topk_compress({"x": t(x)}, ratio)
    assert vals["x"].numel() == np.asarray(ref_vals["x"]).size == k


def test_topk_compress_roundtrip_matches_reference():
    """Distinct magnitudes, so the pick does not depend on tie order."""
    rng = np.random.default_rng(8)
    g = {"a": rng.permutation(60).reshape(3, 4, 5).astype(np.float32) - 30.5,
         "b": rng.permutation(7).astype(np.float32) + 0.5}
    resid = {k: rng.normal(0, 0.1, v.shape).astype(np.float32)
             for k, v in g.items()}
    (rv, ri), ref_ef = ref_comp.topk_compress(
        jx(g), 0.3, ref_comp.ErrorFeedbackState(jx(resid)))
    (pv, pi), ef = compression.topk_compress(
        th(g), 0.3, compression.ErrorFeedbackState(th(resid)))
    assert_trees_close(rv, pv, atol=0)
    for a, b in zip(jax.tree_util.tree_leaves(ri), tree_leaves(pi)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert_trees_close(ref_ef.residual, ef.residual, atol=0)
    assert_trees_close(ref_comp.topk_decompress(rv, ri, jx(g)),
                       compression.topk_decompress(pv, pi, th(g)), atol=0)


# ---- local SGD ----

def shards(n, W, seed=0):
    cfg = ref_cnn_b()
    x, y = ref_synthetic.make_classification_dataset(
        max(n * W, 1), cfg.input_shape, cfg.num_classes, noise=1.0, seed=seed)
    return (x[: n * W].reshape(n, W, *cfg.input_shape),
            y[: n * W].reshape(n, W))


@pytest.mark.parametrize("W,batch_size", [(24, 8), (5, 8)])
def test_local_train_batch_matches_reference(W, batch_size):
    """CNN-B across a 3-device cohort; W = 5 < batch trains one full-shard
    batch per epoch."""
    x, y = shards(3, W)
    ref = ref_runtime._local_train_batch(
        ref_cnn_init(ref_cnn_b(), seed=0), ref_cnn_b(), jnp.asarray(x),
        jnp.asarray(y), 2, batch_size, 0.05)
    got = runtime._local_train_batch(
        cnn_init(cnn_b(), seed=0, device="cpu"), cnn_b(), t(x), t(y).long(),
        2, batch_size, 0.05)
    scale = max(float(np.abs(np.asarray(a)).max())
                for a in jax.tree_util.tree_leaves(ref))
    assert_trees_close(ref, got, rtol=0, atol=1e-5 * scale)
    one = runtime._local_train_one(cnn_init(cnn_b(), seed=0, device="cpu"),
                                   cnn_b(), t(x[1]), t(y[1]).long(), 2,
                                   batch_size, 0.05)
    for a, b in zip(tree_leaves(got), tree_leaves(one)):
        np.testing.assert_allclose(a[1].numpy(), b.numpy(), rtol=0,
                                   atol=1e-5 * scale)


def test_local_train_width0_shard_is_identity():
    params = cnn_init(cnn_b(), seed=0, device="cpu")
    x = torch.zeros((0,) + cnn_b().input_shape)
    y = torch.zeros((0,), dtype=torch.int64)
    out = runtime._local_train_one(params, cnn_b(), x, y, 3, 32, 0.05)
    for a, b in zip(tree_leaves(params), tree_leaves(out)):
        assert torch.equal(a, b)
    batch = runtime._local_train_batch(params, cnn_b(), x[None].expand(
        2, *x.shape), y[None].expand(2, 0), 3, 32, 0.05)
    for a, b in zip(tree_leaves(params), tree_leaves(batch)):
        assert b.shape == (2,) + a.shape and torch.equal(b[0], a)
