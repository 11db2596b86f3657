"""The CUDA plan-scoring kernel against its plain PyTorch version, on the
card. Marked ``requires_cuda``: without a card (or nvcc) every test skips,
decided inside the fixture. Run on a GPU machine with

    PYTHONPATH=src python -m pytest -q -m requires_cuda tests/test_torch_cuda.py

Imports neither jax nor the reference (the GPU machine need not have them).
Columns 0 and 1 must be exact; column 2 within 1e-5 * max(1, sum |w| over
the selected devices), since the kernel sums in another order.
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
