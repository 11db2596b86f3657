"""The port's CNN zoo against the reference's (``repro.models.cnn_zoo``,
default ``gemm`` lowering) on the CPU.

``cnn_init`` must be bit-identical (the same numpy draws, rounded to
float32 once). Logits and gradients agree within a tolerance: both packages
compute in float32 but sum the im2col matmuls in another order (different
BLAS blocking), so results differ in the last bits, scaled by the size of
the values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.config.registry import get_arch as ref_get_arch  # noqa: E402
from repro.models import cnn_zoo as ref_zoo  # noqa: E402
from repro_torch.config.registry import get_arch, list_archs  # noqa: E402
from repro_torch.models import cnn_zoo  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ARCHS = ("paper-vgg16", "paper-cnn-a-iid", "paper-cnn-a-noniid",
         "paper-lenet5", "paper-resnet18", "paper-cnn-b", "paper-alexnet")
# Logits: float32 matmul sums in another order, relative to the largest
# logit (measured up to 2e-6 on resnet18, the deepest).
LOGIT_RTOL = 2e-5
# Gradients: the backward adds one more level of reordered sums.
GRAD_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs several test files at once, and
    the timing-sensitive tests of other files must not be starved."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def max_err(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


def test_registry_lists_the_paper_zoo():
    assert tuple(sorted(ARCHS)) == tuple(list_archs())
    with pytest.raises(NotImplementedError, match="module 10"):
        get_arch("qwen3-8b")
    with pytest.raises(KeyError):
        get_arch("no-such-arch")


@pytest.mark.parametrize("arch", ARCHS)
def test_cnn_init_bit_identical(arch):
    ref_cfg, cfg = ref_get_arch(arch), get_arch(arch)
    assert cfg.param_count() == ref_cfg.param_count()
    ref = jax.tree_util.tree_leaves(ref_zoo.cnn_init(ref_cfg, seed=7))
    port = tree_leaves(cnn_zoo.cnn_init(cfg, seed=7))
    assert len(ref) == len(port)
    assert sum(p.numel() for p in port) == cfg.param_count()
    for a, b in zip(ref, port):
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_reference(arch):
    ref_cfg, cfg = ref_get_arch(arch), get_arch(arch)
    x = np.random.default_rng(1).normal(
        size=(2,) + cfg.input_shape).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, v: ref_zoo.cnn_apply(p, ref_cfg, v))(
        ref_zoo.cnn_init(ref_cfg, seed=2), jnp.asarray(x)))
    got = cnn_zoo.cnn_apply(cnn_zoo.cnn_init(cfg, seed=2), cfg,
                            torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, cfg.num_classes)
    assert max_err(got, ref) <= LOGIT_RTOL * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("arch", ["paper-lenet5", "paper-cnn-b"])
def test_gradients_match_reference(arch):
    """LeNet-5 (5x5 kernels, two pools) and CNN-B (even 2x2 kernels: the
    asymmetric SAME padding at stride 1)."""
    ref_cfg, cfg = ref_get_arch(arch), get_arch(arch)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4,) + cfg.input_shape).astype(np.float32)
    y = rng.integers(0, cfg.num_classes, 4).astype(np.int32)

    def ref_loss(p):
        return ref_zoo.cnn_loss_and_accuracy(p, ref_cfg, jnp.asarray(x),
                                             jnp.asarray(y))[0]

    ref_g = jax.tree_util.tree_leaves(
        jax.jit(jax.grad(ref_loss))(ref_zoo.cnn_init(ref_cfg, seed=4)))
    got_g = tree_leaves(torch.func.grad(
        lambda p: cnn_zoo.cnn_loss_and_accuracy(
            p, cfg, torch.from_numpy(x), torch.from_numpy(y).long())[0])(
        cnn_zoo.cnn_init(cfg, seed=4)))
    for a, b in zip(ref_g, got_g):
        scale = max(1e-3, float(np.abs(np.asarray(a)).max()))
        assert max_err(a, b.numpy()) <= GRAD_RTOL * scale


def test_maxpool_tie_gradient_matches_reference():
    """Tied windows (all zeros, as after ReLU, and equal positive values)
    split the gradient evenly, as JAX's reshape-max does; the values must
    be equal, not merely close."""
    x = np.zeros((1, 4, 6, 2), np.float32)
    x[0, 2:, :2, 0] = 3.0                      # a tied positive window
    x[0, 0, 4, 1] = 1.0                        # an untied window
    r = np.random.default_rng(5).normal(size=(1, 2, 3, 2)).astype(np.float32)
    ref = jax.grad(lambda v: (ref_zoo._maxpool2(v) * r).sum())(jnp.asarray(x))
    got = torch.func.grad(lambda v: (cnn_zoo._maxpool2(v)
                                     * torch.from_numpy(r)).sum())(
        torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.numpy()[0, :2, :2, 0],
                                  np.full((2, 2), r[0, 0, 0, 0] / 4))


def test_groupnorm_matches_reference():
    """min(8, c) contiguous groups, population variance, rsqrt(var + 1e-5)."""
    x = np.random.default_rng(6).normal(size=(2, 8, 8, 16)).astype(np.float32)
    p = {"scale": np.linspace(0.5, 1.5, 16).astype(np.float32),
         "bias": np.linspace(-1, 1, 16).astype(np.float32)}
    ref = np.asarray(ref_zoo._groupnorm(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}))
    got = cnn_zoo._groupnorm(torch.from_numpy(x),
                             {k: torch.from_numpy(v) for k, v in p.items()})
    assert max_err(got.numpy(), ref) <= 1e-5


@pytest.mark.parametrize("k,stride,hw", [(2, 1, 7), (3, 2, 8), (1, 2, 7),
                                         (5, 1, 6)])
def test_conv_padding_matches_reference(k, stride, hw):
    """SAME padding, ``pad // 2`` before and the rest after: odd and even
    kernels, strides 1 and 2, even and odd sizes."""
    rng = np.random.default_rng(k * 10 + stride)
    x = rng.normal(size=(2, hw, hw, 3)).astype(np.float32)
    w = rng.normal(size=(k, k, 3, 4)).astype(np.float32)
    b = rng.normal(size=(4,)).astype(np.float32)
    ref = np.asarray(ref_zoo._conv(jnp.asarray(x), {"w": jnp.asarray(w),
                                                    "b": jnp.asarray(b)},
                                   stride))
    got = cnn_zoo._conv(torch.from_numpy(x), {"w": torch.from_numpy(w),
                                              "b": torch.from_numpy(b)},
                        stride).numpy()
    assert got.shape == ref.shape
    assert max_err(got, ref) <= 1e-5 * max(1.0, np.abs(ref).max())
