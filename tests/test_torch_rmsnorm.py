"""The port's RMSNorm (``kernels/rmsnorm.py``, reached through
``ops.rmsnorm``) against the reference's oracle and its Pallas kernel in
interpret mode, on the CPU, with the same numpy inputs. Tolerances are the
reference kernel tests' (tests/test_kernels_rmsnorm.py): 1e-5 in float32,
2e-2 in bfloat16.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm as pallas_rmsnorm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.models import layers  # noqa: E402

CASES = [  # shape, Pallas block rows (tests/test_kernels_rmsnorm.py:10-15)
    ((4, 37, 256), 64),
    ((128, 512), 128),
    ((1, 1, 1024), 8),
    ((3, 5, 7, 64), 16),
    ((5, 1600), 8),       # hymba's width
]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs several test files at once, and
    the timing-sensitive tests of other files must not be starved."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 2, shape).astype(np.float32),
            rng.normal(1, 0.1, shape[-1:]).astype(np.float32))


@pytest.mark.parametrize("shape,block", CASES)
def test_rmsnorm_matches_reference(shape, block):
    x, s = inputs(shape, seed=len(shape) * 100 + shape[-1])
    exp = ref.rmsnorm(jnp.asarray(x), jnp.asarray(s))
    interp = pallas_rmsnorm(jnp.asarray(x), jnp.asarray(s), block_rows=block,
                            interpret=True)
    before = rn.launches
    got = rn.rmsnorm(torch.as_tensor(x), torch.as_tensor(s))
    assert rn.launches == before   # CPU tensors take the plain version
    assert got.shape == x.shape and got.dtype == torch.float32
    for e in (exp, interp):
        np.testing.assert_allclose(got.numpy(), np.asarray(e), atol=1e-5,
                                   rtol=1e-5)
    np.testing.assert_array_equal(
        ops.rmsnorm(torch.as_tensor(x), torch.as_tensor(s), impl="ref"),
        got.numpy())


@pytest.mark.parametrize("dtype,tol", [("bfloat16", 2e-2), ("float32", 1e-5)])
def test_rmsnorm_dtypes(dtype, tol):
    x, s = inputs((32, 128))
    jdt = {"bfloat16": jnp.bfloat16, "float32": jnp.float32}[dtype]
    tdt = {"bfloat16": torch.bfloat16, "float32": torch.float32}[dtype]
    exp = ref.rmsnorm(jnp.asarray(x, jdt), jnp.asarray(s))
    got = ops.rmsnorm(torch.as_tensor(x).to(tdt), torch.as_tensor(s))
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(exp.astype(jnp.float32)), atol=tol,
                               rtol=tol)


def test_rmsnorm_equals_the_models_own():
    """The kernel's plain version and the models' rmsnorm compute the same
    function (the models keep their own, as in the reference)."""
    x, s = inputs((6, 64), seed=3)
    t, ts = torch.as_tensor(x), torch.as_tensor(s)
    torch.testing.assert_close(rn.rmsnorm_ref(t, ts, 1e-5),
                               layers.rmsnorm({"scale": ts}, t, 1e-5),
                               rtol=0, atol=0)


def test_rmsnorm_rejects_bad_inputs():
    with pytest.raises(TypeError):
        rn.rmsnorm(torch.zeros((2, 8)), torch.ones(7))
    with pytest.raises(TypeError):
        rn.rmsnorm(torch.zeros((2, 8), dtype=torch.float64), torch.ones(8))
