"""The CUDA kernels (plan scoring, compressed-FedAvg scatter-add) against
their plain PyTorch versions, on the card. Marked ``requires_cuda``: without a card (or nvcc) every test skips,
decided inside the fixture. Run on a GPU machine with

    PYTHONPATH=src python -m pytest -q -m requires_cuda tests/test_torch_cuda.py

Imports neither jax nor the reference (the GPU machine need not have them).
plan_stats: columns 0 and 1 must be exact; column 2 within 1e-5 * max(1,
sum |w| over the selected devices), since the kernel sums in another order.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import scoring  # noqa: E402
from repro_torch.kernels import sched_score  # noqa: E402

pytestmark = pytest.mark.requires_cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def check(times, weights, plans):
    before = sched_score.launches
    got = sched_score.plan_stats(times, weights, plans)
    torch.cuda.synchronize()
    assert sched_score.launches == before + (plans.shape[0] > 0)
    exp = sched_score.plan_stats_ref(times, weights, plans)
    got, exp = got.cpu().numpy(), exp.cpu().numpy()
    np.testing.assert_array_equal(got[:, 0], exp[:, 0])
    np.testing.assert_array_equal(got[:, 1], exp[:, 1])
    sel = (plans != 0).cpu().numpy()
    scale = np.maximum(1.0, np.where(sel, np.abs(weights.cpu().numpy()),
                                     0.0).sum(axis=1))
    assert np.all(np.abs(got[:, 2] - exp[:, 2]) <= 1e-5 * scale)


@pytest.mark.parametrize("P,K", [(1, 10_000), (512, 10_000), (37, 1001),
                                 (64, 16), (3, 1), (8, 262_144)])
def test_kernel_matches_plain(cuda, P, K):
    g = torch.Generator(device=cuda).manual_seed(P * 1000 + K)
    times = torch.rand(K, device=cuda, generator=g) * 100
    weights = 2.0 * torch.randint(0, 50, (K,), device=cuda,
                                  generator=g).float() + 1.0
    plans = torch.rand((P, K), device=cuda, generator=g) < 0.01
    if P > 2:
        plans[0] = False
        plans[1] = True
    inf_cols = torch.arange(0, K, 97, device=cuda)
    times[inf_cols] = torch.inf
    if P > 2:
        plans[2:, inf_cols] = False
    check(times, weights, plans.view(torch.int8))


def test_unaligned_rows_and_views(cuda):
    base = torch.zeros((5, 1024 + 1), dtype=torch.int8, device=cuda)
    base[:, 1::3] = 1
    view = base[:, 1:].contiguous()  # K % 16 == 0 after the copy
    times = torch.rand(1024, device=cuda)
    check(times, torch.ones(1024, device=cuda), view)
    odd = torch.zeros(16 * 7 + 1, dtype=torch.int8, device=cuda)[1:]
    odd[::5] = 1  # a 16-aligned K on a pointer that is not 16-aligned
    check(times[:112], torch.ones(112, device=cuda), odd.view(1, 112))


def test_cuda_scoring_backend_matches_torch(cuda):
    rng = np.random.default_rng(0)
    K, P = 10_000, 512
    times = rng.uniform(0.1, 100.0, K)
    counts = rng.integers(0, 5, K).astype(np.float64)
    plans = rng.random((P, K)) < 0.01
    kw = dict(alpha=4.0, beta=0.25, time_scale=3.0, fairness_scale=0.0099)
    a = scoring.score_plans(times, counts, plans, backend="cuda",
                            device="cuda", **kw)
    b = scoring.score_plans(times, counts, plans, backend="torch",
                            device="cuda", **kw)
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


# ---- the compressed-FedAvg scatter-add (kernels/csrc/scatter_add.cu) ----
# Within 1e-5 relative plus absolute of the plain version: the kernel sums
# with float atomics, in another order.

from repro_torch.fl.aggregation import fedavg, fedavg_compressed  # noqa: E402
from repro_torch.kernels import scatter_add as sa  # noqa: E402


def check_scatter(vals, idx, w, size):
    before = sa.launches
    got = sa.scatter_add(vals, idx, w, size)
    torch.cuda.synchronize()
    assert sa.launches == before + (vals.numel() > 0)
    exp = sa.scatter_add_ref(vals, idx, w, size)
    np.testing.assert_allclose(got.cpu().numpy(), exp.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,k,size,dtype", [
    (3, 17, 64, torch.int64), (8, 32, 300, torch.int32),
    (1, 5, 1000, torch.int64), (16, 64, 4096, torch.int32),
    (10, 1678, 167_772, torch.int64), (7, 301, 1, torch.int64)])
def test_scatter_add_matches_plain(cuda, n, k, size, dtype):
    g = torch.Generator(device=cuda).manual_seed(n * 1000 + k)
    vals = torch.randn((n, k), device=cuda, generator=g)
    idx = torch.randint(-2, size + 2, (n, k), device=cuda,
                        generator=g).to(dtype)  # padding and past-the-end
    w = torch.rand(n, device=cuda, generator=g) + 0.1
    check_scatter(vals, idx, w, size)


def test_scatter_add_all_collisions_and_empty(cuda):
    vals = torch.randn((4, 9), device=cuda)
    w = torch.rand(4, device=cuda) + 0.5
    idx = torch.zeros((4, 9), dtype=torch.int64, device=cuda)
    check_scatter(vals, idx, w, 16)
    empty = torch.zeros((0, 3), device=cuda)
    check_scatter(empty, empty.long(), torch.zeros(0, device=cuda), 5)


def test_scatter_add_rejects_bad_inputs(cuda):
    vals = torch.randn((2, 3), device=cuda)
    idx = torch.zeros((2, 3), dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError):
        sa.scatter_add(vals.double(), idx, torch.ones(2, device=cuda), 4)
    with pytest.raises(ValueError):
        sa.scatter_add(vals, idx.cpu(), torch.ones(2, device=cuda), 4)
    with pytest.raises(ValueError):
        sa.scatter_add(vals.t(), idx.t(), torch.ones(3, device=cuda), 4)


def test_fedavg_compressed_cuda_matches_ref(cuda):
    g = torch.Generator(device=cuda).manual_seed(5)
    glob = [{"w": torch.randn((5, 5, 1, 4), device=cuda, generator=g),
             "b": torch.randn(4, device=cuda, generator=g)},
            {"w": torch.randn((36, 10), device=cuda, generator=g),
             "b": torch.randn(10, device=cuda, generator=g)}]
    stacked = [{k: v[None] + 0.1 * torch.randn((5,) + v.shape, device=cuda,
                                               generator=g)
                for k, v in layer.items()} for layer in glob]
    w = torch.rand(5, device=cuda, generator=g) + 0.5
    before = sa.launches
    a = fedavg_compressed(glob, stacked, w, 0.25, impl="cuda")
    assert sa.launches == before + 4
    b = fedavg_compressed(glob, stacked, w, 0.25, impl="ref")
    full = fedavg_compressed(glob, stacked, w, 1.0, impl="cuda")
    plain = fedavg(stacked, w)
    for la, lb, lf, lp in zip(a, b, full, plain):
        for key in la:
            np.testing.assert_allclose(la[key].cpu(), lb[key].cpu(),
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(lf[key].cpu(), lp[key].cpu(),
                                       rtol=1e-5, atol=1e-5)
