"""The CUDA kernels (plan scoring, compressed-FedAvg scatter-add, flash
and decode attention, the MoE grouped matmul, the linear scan, RMSNorm)
against their plain PyTorch versions, on the card, and the fleet-sharded
scoring and fused searches (module 7) against the single lane. Marked
``requires_cuda``: without a card (or nvcc) every test skips, decided
inside the fixture. Run on a GPU machine with

    PYTHONPATH=src python -m pytest -q -m requires_cuda \
        tests/test_torch_cuda.py

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


def check(times, weights, plans, variant=None):
    """``plan_stats`` (or, given ``variant``, one ``launch_variant``, which
    counts nothing) against the plain version: columns 0 and 1 exact,
    column 2 within 1e-5 * max(1, sum |w| over the selected devices).
    Returns the kernel's stats."""
    before = sched_score.launches
    picked = sched_score.kernel_variant(*plans.shape,
                                        plans.data_ptr() % 16 == 0)
    before_v = dict(sched_score.launches_by_variant)
    if variant is None:
        got = sched_score.plan_stats(times, weights, plans)
        launched = plans.shape[0] > 0
    else:
        got = sched_score.launch_variant(variant, times, weights, plans)
        launched = False
    torch.cuda.synchronize()
    assert sched_score.launches == before + launched
    assert sched_score.launches_by_variant == {
        v: n + (launched and v == picked) for v, n in before_v.items()}
    exp = sched_score.plan_stats_ref(times, weights, plans)
    out = got
    got, exp = got.cpu().numpy(), exp.cpu().numpy()
    np.testing.assert_array_equal(got[:, 0], exp[:, 0])
    np.testing.assert_array_equal(got[:, 1], exp[:, 1])
    sel = (plans != 0).cpu().numpy()
    scale = np.maximum(1.0, np.where(sel, np.abs(weights.cpu().numpy()),
                                     0.0).sum(axis=1))
    assert np.all(np.abs(got[:, 2] - exp[:, 2]) <= 1e-5 * scale)
    return out


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


def stats_problem(cuda, P, K, density, seed):
    """Times with +inf on devices only the all-selected row picks, centred
    count weights (as the cuda backend builds them), and plans of the
    given density; for P > 2 row 0 selects nothing and row 1 everything."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    times = torch.rand(K, device=cuda, generator=g) * 100 + 0.1
    counts = torch.randint(0, 6, (K,), device=cuda, generator=g).double()
    weights = (2.0 * (counts - counts.mean()) + 1.0).float()
    plans = torch.rand((P, K), device=cuda, generator=g) < density
    inf_cols = torch.arange(3, K, 41, device=cuda)
    times[inf_cols] = torch.inf
    plans[:, inf_cols] = False
    if P > 2:
        plans[0] = False
        plans[1] = True
    return times, weights, plans.view(torch.int8)


VARIANT_SHAPES = [  # P, K, density
    (1, 10_000, 0.01), (64, 10_000, 0.025), (64, 10_000, 0.5),
    (512, 10_000, 0.01), (37, 1001, 0.1), (8, 262_144, 0.01)]


def serving(P, K, aligned=True):
    return [v for v in sched_score.VARIANTS
            if sched_score.serves(v, P, K, aligned)]


@pytest.mark.parametrize("P,K,density", VARIANT_SHAPES)
def test_every_variant_matches_plain(cuda, P, K, density):
    times, weights, plans = stats_problem(cuda, P, K, density, P * 7 + K)
    for variant in serving(P, K):
        got = check(times, weights, plans, variant=variant).cpu()
        assert torch.isfinite(got[2:, 0] if P > 2 else got[:, 0]).all()
        if P > 2:
            assert got[0].tolist() == [float(np.float32(sched_score.NEG_INF)),
                                       0.0, 0.0]
            assert got[1, 0] == torch.inf and got[1, 1] == K
    check(times, weights, plans)  # the picked variant, counted


@pytest.mark.parametrize("P,K", [(1500, 4096), (600, 16 * 769),
                                 (529, 16 * 1536), (2, 16 * 2305)])
def test_stream_walks_rows_and_chunks(cuda, P, K):
    """``stream``'s persistent grid: more rows than resident blocks (each
    block takes several), rows of one chunk and a vector more, of exactly
    two chunks and of three chunks and a vector, so the next row's loads
    are issued from a row's last chunk."""
    times, weights, plans = stats_problem(cuda, P, K, 0.02, P + K)
    check(times, weights, plans, variant="stream")


@pytest.mark.parametrize("P,K,density", VARIANT_SHAPES)
def test_weight_sum_bitwise_under_permuted_positions(cuda, P, K, density):
    """Column 2 is the same float, bit for bit, when the devices (times,
    weights and plan columns alike) are permuted, on every variant: the
    sum is taken in double and rounded once."""
    times, weights, plans = stats_problem(cuda, P, K, density, 5 * P + K)
    g = torch.Generator(device=cuda).manual_seed(K)
    perm = torch.randperm(K, device=cuda, generator=g)
    for variant in serving(P, K):
        a = sched_score.launch_variant(variant, times, weights, plans)
        b = sched_score.launch_variant(variant, times[perm], weights[perm],
                                       plans[:, perm].contiguous())
        torch.cuda.synchronize()
        assert torch.equal(a, b), variant


def test_entry_refuses_what_a_variant_cannot_serve(cuda):
    times, weights, plans = stats_problem(cuda, 4, 1001, 0.1, 3)
    assert not sched_score.serves("stream", 4, 1001, True)
    with pytest.raises(RuntimeError):
        sched_score.launch_variant("stream", times, weights, plans)
    base = torch.zeros(16 * 9 + 1, dtype=torch.int8, device=cuda)
    odd = base[1:].view(1, 144)  # K % 16 == 0 on an unaligned pointer
    assert odd.data_ptr() % 16 and sched_score.kernel_variant(
        1, 144, False) == "row"
    with pytest.raises(RuntimeError):
        sched_score.launch_variant("stream", times[:144], weights[:144], odd)
    ok = torch.zeros((2, 32), dtype=torch.int8, device=cuda)
    # stream reads times and weights 16 bytes at a time
    with pytest.raises(RuntimeError):
        sched_score.launch_variant("stream", times[1:33], weights[:32], ok)


def test_unaligned_times_and_weights(cuda):
    """``plan_stats`` copies times or weights that do not start on a
    16-byte boundary before it launches ``stream``."""
    times, weights, plans = stats_problem(cuda, 40, 4097, 0.3, 9)
    plans = plans[:, 1:].contiguous()
    assert sched_score.kernel_variant(40, 4096, True) == "stream"
    check(times[1:], weights[1:], plans)
    check(times[:4096], weights[1:], plans)


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
    variant = sa.kernel_variant(*vals.shape, size)
    before_v = sa.launches_by_variant[variant]
    got = sa.scatter_add(vals, idx, w, size)
    torch.cuda.synchronize()
    assert sa.launches == before + (vals.numel() > 0)
    assert sa.launches_by_variant[variant] == before_v + (vals.numel() > 0)
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


# Each variant of the scatter-add on the edges its tiles create: T is the
# tile size in floats.
T = sa.TILE
SCATTER_CASES = {
    # name: (n, k, size)
    "padding-and-past-the-end": (6, 700, 3 * T + 5),
    "repeats-in-row": (4, 2000, T + 100),
    "one-position": (8, 1000, 2 * T),
    "size-1": (5, 30, 1),
    "size-T": (4, 500, T),
    "size-T-minus-1": (4, 500, T - 1),
    "size-T-plus-1": (4, 500, T + 1),
    "tiles-with-no-entry": (3, 1000, 6 * T),
    "long-stream": (10, 20_000, 5 * T + 3),
    "one-tile-one-entry-a-thread": (2, 512, T),
    "output-past-the-l2": (10, 3000, 2 ** 23 + 1),
}


def scatter_case(cuda, name, dtype):
    n, k, size = SCATTER_CASES[name]
    g = torch.Generator(device=cuda).manual_seed(n * k + size)
    vals = torch.randn((n, k), device=cuda, generator=g)
    w = torch.rand(n, device=cuda, generator=g) + 0.1
    idx = torch.randint(0, size, (n, k), device=cuda, generator=g)
    if name == "padding-and-past-the-end":
        idx = torch.randint(-3, size + 3, (n, k), device=cuda, generator=g)
        idx[:, 5::50] = 2 ** 40 if dtype == torch.int64 else 2 ** 31 - 1
    elif name == "repeats-in-row":
        idx[:, 1::2] = idx[:, ::2]
    elif name == "one-position":
        idx.fill_(T + 3)
    elif name == "size-1":
        idx[:, ::3] = -1
    elif name == "size-T-plus-1":
        idx[:, :2] = T                       # the second tile's one float
    elif name == "tiles-with-no-entry":
        idx = idx % T
        idx[:, 1::2] += 4 * T                # tiles 0 and 4 only
    return vals, idx.to(dtype).contiguous(), w, size


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("name", list(SCATTER_CASES))
@pytest.mark.parametrize("variant", sa.VARIANTS)
def test_scatter_add_variant_matches_plain(cuda, variant, name, dtype):
    """Every variant against the plain version within 1e-5 relative plus
    absolute; the entry refuses a shape the variant does not serve (tile:
    an output past one tile)."""
    vals, idx, w, size = scatter_case(cuda, name, dtype)
    if not sa.serves(variant, *vals.shape, size):
        with pytest.raises(RuntimeError, match="CUDA error 1 "):
            sa.launch_variant(variant, vals, idx, w, size)
        return
    got = sa.launch_variant(variant, vals, idx, w, size)
    torch.cuda.synchronize()
    exp = sa.scatter_add_ref(vals, idx, w, size)
    np.testing.assert_allclose(got.cpu().numpy(), exp.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", list(SCATTER_CASES))
def test_scatter_add_picks_its_variant(cuda, name):
    """Through ``scatter_add``: the variant ``kernel_variant`` names is the
    one that launches, and the result holds."""
    check_scatter(*scatter_case(cuda, name, torch.int64))


@pytest.mark.parametrize("size", [1, T, T + 1, 100 * T])
def test_scatter_add_empty_stream_launches_nothing(cuda, size):
    before = (sa.launches, dict(sa.launches_by_variant))
    for n, k in ((0, 7), (4, 0)):
        out = sa.scatter_add(torch.zeros((n, k), device=cuda),
                             torch.zeros((n, k), dtype=torch.int64,
                                         device=cuda),
                             torch.ones(n, device=cuda), size)
        assert out.shape == (size,) and not bool(out.any())
    assert (sa.launches, sa.launches_by_variant) == before


def test_scatter_add_entry_refuses_what_a_variant_cannot_serve(cuda):
    vals = torch.ones((1, 4), device=cuda)
    idx = torch.zeros((1, 4), dtype=torch.int64, device=cuda)
    w = torch.ones(1, device=cuda)
    out = torch.empty(8, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    fn = sa._entry()
    for variant, size in (("tile", T + 1),                 # past one tile
                          ("nonesuch", 8)):
        code = (sa.VARIANTS.index(variant) if variant in sa.VARIANTS
                else len(sa.VARIANTS))
        assert not (variant in sa.VARIANTS and sa.serves(variant, 1, 4, size))
        rc = fn(vals.data_ptr(), idx.data_ptr(), 8, w.data_ptr(),
                out.data_ptr(), code, 1, 4, size, stream)
        assert rc == CUDA_ERROR_INVALID_VALUE, variant


# ---- flash and decode attention (kernels/csrc/{flash,decode}_attention.cu) ----
# The reference's tolerances: 2e-5 in float32; in bfloat16 2e-2 for flash
# and 3e-2 for decode (tests/test_kernels_flash.py, test_kernels_decode.py).

from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402

ATTN_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2e-2, 3e-2)}


def randn(g, shape, dtype):
    return torch.randn(shape, device=g.device, generator=g).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KV,D,causal,window", [
    (2, 128, 4, 2, 64, True, None), (1, 256, 8, 8, 32, True, None),
    (2, 128, 4, 1, 64, True, 64), (1, 64, 2, 2, 128, False, None),
    (3, 64, 4, 4, 16, True, 16), (1, 333, 4, 1, 256, True, None),
    (2, 300, 25, 5, 64, True, 100), (1, 200, 32, 2, 128, False, 50),
    # the wgmma variant's edges: S not a multiple of its 128-row tiles at
    # D = 128 and 64, G = 16, a window over several tiles, one row
    (1, 333, 8, 2, 128, True, None), (2, 200, 4, 2, 64, True, None),
    (1, 300, 16, 1, 128, True, None), (1, 700, 25, 5, 64, True, 256),
    (2, 130, 4, 4, 128, False, None), (1, 1, 4, 2, 128, True, None),
    # kimi-k2's 64/8 heads of 112 (wgmma at D = 128, zero-padded)
    (1, 300, 64, 8, 112, True, None), (2, 130, 8, 2, 112, False, None),
    (1, 500, 16, 8, 112, True, 128)])
def test_flash_matches_plain(cuda, dtype, B, S, H, KV, D, causal, window):
    g = torch.Generator(device=cuda).manual_seed(S * 7 + H)
    q = randn(g, (B, S, H, D), dtype)
    k = randn(g, (B, S, KV, D), dtype)
    v = randn(g, (B, S, KV, D), dtype)
    variant = fa.kernel_variant(dtype, B, S, H, KV, D, window)
    assert variant == ("simt" if dtype == torch.float32 else
                       "wgmma" if D in fa.WGMMA_HEAD_DIMS else "mma")
    before, before_v = fa.launches, fa.launches_by_variant[variant]
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.launches == before + 1 and got.dtype == dtype
    assert fa.launches_by_variant[variant] == before_v + 1
    exp = fa.attention_ref(q, k, v, causal=causal, window=window)
    tol = ATTN_TOL[dtype][0]
    np.testing.assert_allclose(got.float().cpu(), exp.float().cpu(),
                               atol=tol, rtol=tol)


def test_flash_gradient_through_kernel_forward(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    leaves = [randn(g, s, torch.float32).requires_grad_()
              for s in ((1, 64, 4, 32), (1, 64, 2, 32), (1, 64, 2, 32))]
    (fa.flash_attention(*leaves) ** 2).sum().backward()
    plain = [t.detach().clone().requires_grad_() for t in leaves]
    (fa.attention_ref(*plain) ** 2).sum().backward()
    for a, b in zip(leaves, plain):
        np.testing.assert_allclose(a.grad.cpu(), b.grad.cpu(), atol=5e-4,
                                   rtol=5e-4)


CUDA_ERROR_INVALID_VALUE = 1


@pytest.mark.parametrize("dtype,D,variant", [
    (torch.float32, 128, "wgmma"), (torch.bfloat16, 32, "wgmma"),
    (torch.bfloat16, 256, "wgmma"), (torch.float32, 64, "mma"),
    (torch.bfloat16, 64, "simt"),
    # D = 64, 112 and 128 are the wgmma variant's alone
    (torch.bfloat16, 64, "mma"), (torch.bfloat16, 128, "mma"),
    (torch.bfloat16, 112, "mma")])
def test_flash_entry_refuses_a_variant_that_cannot_serve(cuda, dtype, D,
                                                         variant):
    q = torch.zeros((1, 64, 2, D), device=cuda, dtype=dtype)
    out = torch.empty_like(q)
    rc = fa._entry()(q.data_ptr(), q.data_ptr(), q.data_ptr(),
                     out.data_ptr(), fa.DTYPES[dtype],
                     fa.VARIANTS.index(variant), 1, 64, 2, 2, D, 1, 0,
                     torch.cuda.current_stream().cuda_stream)
    assert rc == CUDA_ERROR_INVALID_VALUE


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KV,D,T", [
    (2, 4, 2, 64, 128), (3, 8, 1, 32, 256), (2, 8, 8, 128, 64),
    (16, 16, 8, 128, 4096), (4, 32, 2, 128, 1000), (2, 4, 2, 256, 777),
    (5, 16, 16, 16, 100),
    # kimi-k2's 64/8 heads of 112; G = 32 (the simt variant in bf16 too)
    (3, 64, 8, 112, 777), (16, 64, 8, 112, 4096), (2, 32, 1, 64, 300)])
def test_decode_matches_plain(cuda, dtype, B, H, KV, D, T):
    g = torch.Generator(device=cuda).manual_seed(T + H)
    q = randn(g, (B, H, D), dtype)
    k = randn(g, (B, T, KV, D), dtype)
    v = randn(g, (B, T, KV, D), dtype)
    length = torch.randint(1, T + 1, (B,), device=cuda, generator=g).int()
    length[0] = 0
    length[1] = T
    variant = da.kernel_variant(dtype, B, H, KV, D, T)
    assert variant == ("tma" if dtype == torch.bfloat16 and H // KV <= 16
                       and D >= 64 else "simt")
    before, before_v = da.launches, da.launches_by_variant[variant]
    got = da.decode_attention(q, k, v, length)
    torch.cuda.synchronize()
    assert da.launches == before + 1 and got.dtype == dtype
    assert da.launches_by_variant[variant] == before_v + 1
    exp = da.decode_attention_ref(q, k, v, length)
    tol = ATTN_TOL[dtype][1]
    np.testing.assert_allclose(got.float().cpu(), exp.float().cpu(),
                               atol=tol, rtol=tol)
    # rows past each length are never read
    k2, v2 = k.clone(), v.clone()
    for b, n in enumerate(length.tolist()):
        if 0 < n < T:
            k2[b, n:] = 1e4
            v2[b, n:] = float("nan")
    again = da.decode_attention(q, k2, v2, length)
    assert torch.equal(again, got)


@pytest.mark.parametrize("dtype,H,KV,D,variant", [
    (torch.float32, 8, 2, 64, "tma"), (torch.bfloat16, 32, 1, 64, "tma"),
    (torch.bfloat16, 8, 2, 32, "tma")])
def test_decode_entry_refuses_a_variant_that_cannot_serve(cuda, dtype, H, KV,
                                                          D, variant):
    q = torch.zeros((2, H, D), device=cuda, dtype=dtype)
    kv = torch.zeros((2, 64, KV, D), device=cuda, dtype=dtype)
    length = torch.full((2,), 64, dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="CUDA error 1 "):
        da.launch_variant(variant, q, kv, kv, length, torch.empty_like(q))


def test_decode_rejects_bad_inputs(cuda):
    q = torch.zeros((2, 4, 64), device=cuda)
    kv = torch.zeros((2, 8, 2, 64), device=cuda)
    with pytest.raises(TypeError, match="int32"):
        da.decode_attention(q, kv, kv, torch.zeros(2, dtype=torch.int64,
                                                   device=cuda))
    with pytest.raises(ValueError, match="several devices"):
        da.decode_attention(q, kv, kv, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="D in"):
        da.decode_attention(q[..., :48].contiguous(),
                            kv[..., :48].contiguous(),
                            kv[..., :48].contiguous(),
                            torch.zeros(2, dtype=torch.int32, device=cuda))


def test_reduced_model_kernels_match_plain_on_card(cuda):
    """A reduced dense model on the card: prefill and decode through the
    kernels against the same model under ``ops.set_default_impl("ref")``."""
    from repro_torch.configs.qwen3_1p7b import reduced
    from repro_torch.kernels import ops
    import dataclasses

    cfg = dataclasses.replace(reduced(), dtype="float32")
    params = tfm.lm_init(cfg, seed=0, device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (2, 40), device=cuda)
    got = tfm.lm_apply(cfg, params, toks)
    ops.set_default_impl("ref")
    try:
        exp = tfm.lm_apply(cfg, params, toks)
    finally:
        ops.set_default_impl("cuda")
    np.testing.assert_allclose(got.cpu(), exp.cpu(), atol=1e-4, rtol=1e-4)


# ---- MoE grouped matmul, linear scan, RMSNorm ----
# The reference's tolerances: moe_gmm 1e-4 in float32 and 2e-2 in bfloat16
# (tests/test_kernels_moe.py), linear_scan 2e-4 (tests/test_kernels_ssm.py),
# rmsnorm 1e-5 and 2e-2 (tests/test_kernels_rmsnorm.py). The weights are
# scaled by 1 / sqrt(din) as the models draw them.

from repro_torch.kernels import moe_gmm as gmm  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402
from repro_torch.kernels import ssm_scan as ss  # noqa: E402

GMM_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,C,din,dout", [
    (4, 96, 192, 320), (2, 128, 256, 256), (8, 64, 128, 512),
    (1, 256, 512, 128), (3, 100, 130, 70), (16, 5, 512, 384),
    (2, 1, 64, 136),
    # the wgmma variant's edges: C not a multiple of its 128-row tiles,
    # din not a multiple of its 64-deep stages, dout of its 256 columns
    (3, 70, 256, 384), (1, 200, 512, 264), (2, 300, 136, 520),
    (4, 64, 64, 256)])
def test_moe_gmm_matches_plain(cuda, dtype, E, C, din, dout):
    g = torch.Generator(device=cuda).manual_seed(E * 100 + C)
    x = randn(g, (E, C, din), dtype)
    w = (torch.randn((E, din, dout), device=cuda, generator=g)
         / din ** 0.5).to(dtype)
    variant = gmm.kernel_variant(dtype, E, C, din, dout)
    before, before_v = gmm.launches, gmm.launches_by_variant[variant]
    got = gmm.moe_gmm(x, w)
    torch.cuda.synchronize()
    assert gmm.launches == before + 1 and got.dtype == dtype
    assert gmm.launches_by_variant[variant] == before_v + 1
    if dtype == torch.bfloat16 and din % 8 == dout % 8 == 0:
        assert variant == "wgmma"
    exp = gmm.moe_gmm_ref(x, w)
    tol = GMM_TOL[dtype]
    np.testing.assert_allclose(got.float().cpu(), exp.float().cpu(),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype,shape,variant", [
    (torch.float32, (2, 128, 256, 256), "wgmma"),
    (torch.bfloat16, (2, 128, 130, 256), "wgmma"),
    (torch.bfloat16, (2, 128, 256, 100), "wgmma"),
    (torch.float32, (2, 128, 256, 256), "mma"),
    (torch.bfloat16, (2, 128, 256, 256), "simt")])
def test_moe_gmm_entry_refuses_a_variant_that_cannot_serve(cuda, dtype,
                                                           shape, variant):
    E, C, din, dout = shape
    x = torch.zeros((E, C, din), device=cuda, dtype=dtype)
    w = torch.zeros((E, din, dout), device=cuda, dtype=dtype)
    out = torch.empty((E, C, dout), device=cuda, dtype=dtype)
    rc = gmm._entry()(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                      gmm.DTYPES[dtype], gmm.VARIANTS.index(variant), E, C,
                      din, dout, torch.cuda.current_stream().cuda_stream)
    assert rc == CUDA_ERROR_INVALID_VALUE


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,Dk,Dv,lo,hi", [
    (2, 128, 2, 16, 32, 0.6, 1.0), (1, 333, 3, 16, 128, 0.6, 1.0),
    (2, 200, 2, 8, 16, 0.01, 0.2), (1, 130, 1, 512, 512, 0.9, 1.0),
    (2, 64, 4, 64, 40, 0.5, 1.0),
    # hymba-1.5b's SSD heads and xlstm-350m's mLSTM state at their widths
    (2, 4096, 25, 16, 128, 0.3, 1.0), (1, 1024, 4, 512, 512, 0.5, 1.0)])
def test_linear_scan_matches_plain(cuda, dtype, B, S, H, Dk, Dv, lo, hi):
    g = torch.Generator(device=cuda).manual_seed(S + Dk)
    q = randn(g, (B, S, H, Dk), dtype)
    k = (0.5 * torch.randn((B, S, H, Dk), device=cuda, generator=g)).to(dtype)
    v = randn(g, (B, S, H, Dv), dtype)
    a = lo + (hi - lo) * torch.rand((B, S, H), device=cuda, generator=g)
    variant = ss.kernel_variant(dtype, B, S, H, Dk, Dv)
    assert variant == ("mma" if dtype == torch.bfloat16 else "simt")
    before, before_v = ss.launches, ss.launches_by_variant[variant]
    got, (S_f, n_f) = ss.linear_scan(q, k, v, a)
    torch.cuda.synchronize()
    assert ss.launches == before + 1 and got.dtype == dtype
    assert ss.launches_by_variant[variant] == before_v + 1
    assert bool(torch.isfinite(got).all())
    exp, (S_e, n_e) = ss.linear_scan_chunked_ref(q.float(), k.float(),
                                                 v.float(), a)
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(got.float().cpu(), exp.cpu(), atol=tol,
                               rtol=tol)
    for s_, e in ((S_f, S_e), (n_f, n_e)):
        np.testing.assert_allclose(s_.cpu(), e.cpu(), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("dtype,chunk", [(torch.float32, 64),
                                         (torch.bfloat16, 96)])
def test_linear_scan_entry_refuses_what_mma_cannot_serve(cuda, dtype, chunk):
    """The mma variant takes bf16 and chunks of 64 or 128 only."""
    q = torch.zeros((1, 64, 2, 16), device=cuda, dtype=dtype)
    a = torch.ones((1, 64, 2), device=cuda)
    y = torch.empty_like(q)
    states = torch.empty(4096, device=cuda)
    rc = ss._entry()(q.data_ptr(), q.data_ptr(), q.data_ptr(), a.data_ptr(),
                     y.data_ptr(), states.data_ptr(), states.data_ptr(),
                     ss.DTYPES[dtype], ss.VARIANTS.index("mma"), chunk, 1, 64,
                     2, 16, 16, *q.stride()[:3], *q.stride()[:3],
                     *q.stride()[:3], 7, torch.cuda.current_stream().cuda_stream)
    assert rc == CUDA_ERROR_INVALID_VALUE


def test_linear_scan_strided_views(cuda):
    """q and k sliced out of one projection, as the SSD heads do."""
    g = torch.Generator(device=cuda).manual_seed(3)
    qk = randn(g, (2, 100, 4, 32), torch.bfloat16)
    v = randn(g, (2, 100, 4, 64), torch.bfloat16)
    a = 0.5 + 0.5 * torch.rand((2, 100, 4), device=cuda, generator=g)
    got, state = ss.linear_scan(qk[..., 16:], qk[..., :16], v, a,
                                want_final_state=False)
    assert state is None
    exp, _ = ss.linear_scan_chunked_ref(qk[..., 16:].float(),
                                        qk[..., :16].float(), v.float(), a)
    np.testing.assert_allclose(got.float().cpu(), exp.cpu(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8192, 2048), (16, 6144), (37, 1600),
                                   (3, 5, 7, 64), (5, 100)])
def test_rmsnorm_matches_plain(cuda, dtype, shape):
    g = torch.Generator(device=cuda).manual_seed(shape[-1])
    x = (2 * torch.randn(shape, device=cuda, generator=g)).to(dtype)
    s = 1 + 0.1 * torch.randn(shape[-1:], device=cuda, generator=g)
    before = rn.launches
    variant = rn.kernel_variant(dtype, x.numel() // shape[-1], shape[-1])
    before_v = rn.launches_by_variant[variant]
    got = rn.rmsnorm(x, s)
    torch.cuda.synchronize()
    assert rn.launches == before + 1 and got.dtype == dtype
    assert rn.launches_by_variant[variant] == before_v + 1
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(got.float().cpu(),
                               rn.rmsnorm_ref(x, s).float().cpu(), atol=tol,
                               rtol=tol)


NORM_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2, torch.float16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("rows,d", [
    (1, 6144), (7, 1600), (131, 2048), (301, 6144), (4097, 1600),
    (5, 100), (300, "limit"), (16, "limit"), (300, "past"), (3, "past")])
@pytest.mark.parametrize("variant", rn.VARIANTS)
def test_rmsnorm_variant_matches_plain(cuda, variant, dtype, rows, d):
    """Each variant against the plain version (1e-5 in float32, 2e-2 in
    bf16 and f16); bf16 and f16 rows also within 1e-2 of their norm of the
    plain version run in float32. The resident variant's entry refuses a
    row it cannot hold (no 16-byte vectors, or past its widest row)."""
    limit = rn.max_resident_d(dtype)
    d = {"limit": limit, "past": limit + rn.vector_width(dtype)}.get(d, d)
    g = torch.Generator(device=cuda).manual_seed(rows * 7 + d)
    x = (2 * torch.randn((rows, d), device=cuda, generator=g)).to(dtype)
    s = 1 + 0.1 * torch.randn(d, device=cuda, generator=g)
    out = torch.empty_like(x)
    if variant == "resident" and rn.kernel_variant(dtype, rows, d) == "warp":
        with pytest.raises(RuntimeError, match="CUDA error 1 "):
            rn.launch_variant(variant, x, s, out)
        return
    rn.launch_variant(variant, x, s, out)
    torch.cuda.synchronize()
    tol = NORM_TOL[dtype]
    np.testing.assert_allclose(out.float().cpu(),
                               rn.rmsnorm_ref(x, s).float().cpu(), atol=tol,
                               rtol=tol)
    if dtype != torch.float32:
        exact = rn.rmsnorm_ref(x.float(), s)
        row_err = ((out.float() - exact).norm(dim=-1)
                   / exact.norm(dim=-1).clamp(min=1e-30))
        assert float(row_err.max()) <= 1e-2


@pytest.mark.parametrize("arch", ["dbrx-132b", "kimi-k2-1t-a32b",
                                  "hymba-1.5b", "xlstm-350m"])
def test_reduced_moe_hybrid_ssm_match_plain_on_card(cuda, arch):
    """A reduced MoE, hybrid or SSM model in f32 on the card: prefill and
    decode through the kernels against the same model under
    ``ops.set_default_impl("ref")``; MoE routing ids identical."""
    import dataclasses
    import importlib

    from repro_torch.kernels import ops
    from repro_torch.launch.serve import REDUCED_MODULES

    cfg = dataclasses.replace(
        importlib.import_module(REDUCED_MODULES[arch]).reduced(),
        dtype="float32")
    params = tfm.lm_init(cfg, seed=0, device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (2, 70), device=cuda)
    state = tfm.init_decode_state(cfg, 2, 16, device="cuda")
    ref_state = tfm.init_decode_state(cfg, 2, 16, device="cuda")
    length = torch.tensor([0, 5], dtype=torch.int32, device=cuda)
    got = tfm.lm_apply(cfg, params, toks)
    got_step = tfm.lm_decode_step(cfg, params, state, toks[:, 0], length)[0]
    ops.set_default_impl("ref")
    try:
        exp = tfm.lm_apply(cfg, params, toks)
        exp_step = tfm.lm_decode_step(cfg, params, ref_state, toks[:, 0],
                                      length)[0]
    finally:
        ops.set_default_impl("cuda")
    np.testing.assert_allclose(got.cpu(), exp.cpu(), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got_step.cpu(), exp_step.cpu(), atol=1e-4,
                               rtol=1e-4)


# ---- the fused searches of core/search.py on the card ----
# Fused BODS takes its candidates' statistics from kernel 2.1 (one launch a
# decision, on the device-resident block); under ops.set_default_impl("ref")
# the same decisions must come from the plain statistics. The fused GA's
# noise is host-drawn and its sums f64, so the card repeats the CPU's plans.

def records_of(res):
    return [(r.job, r.round_idx, np.asarray(r.device_ids).tolist())
            for r in res.records]


@pytest.mark.parametrize("num_devices,candidates", [(2048, 128), (1000, 64)])
def test_fused_bods_same_decisions_with_and_without_kernel(cuda, num_devices,
                                                           candidates):
    from repro_torch.experiment.presets import get_preset
    from repro_torch.kernels import ops

    spec = get_preset("fleet-scale", num_devices=num_devices,
                      candidates=candidates, max_rounds=3)
    runs = []
    for impl in ("cuda", "ref"):
        ops.set_default_impl(impl)
        try:
            before = sched_score.launches
            res = spec.run(device="cuda")
            runs.append((records_of(res), sched_score.launches - before))
        finally:
            ops.set_default_impl("cuda")
    (got, launched), (exp, plain_launched) = runs
    assert launched == len(got) > 0 and plain_launched == 0
    assert got == exp


def test_fused_ga_on_card_repeats_the_cpu(cuda):
    from repro_torch.experiment.presets import get_preset

    spec = get_preset("fleet-scale", scheduler="genetic", num_devices=3000,
                      candidates=64, max_rounds=3)
    assert records_of(spec.run(device="cuda")) == \
        records_of(spec.run(device="cpu"))


def test_ei_scores_on_card_match_cpu(cuda):
    from repro_torch.core import search

    rng = np.random.default_rng(0)
    L, P, d = 256, 512, 6
    valid = (rng.random(L) < 0.4).astype(np.float32)
    args = [rng.normal(size=(L, d)), rng.normal(size=L) * valid, valid,
            rng.normal(size=(P, d)), rng.normal(size=P)]
    args = [torch.from_numpy(np.asarray(a, np.float32)) for a in args]
    cpu = search.ei_scores(*args, 0.25)
    card = search.ei_scores(*(a.to(cuda) for a in args), 0.25).cpu()
    np.testing.assert_allclose(card.numpy(), cpu.numpy(), rtol=1e-5,
                               atol=1e-6)


# ---- fleet sharding (module 7) --------------------------------------------

SHARD_KW = dict(alpha=4.0, beta=0.25, time_scale=3.0, fairness_scale=0.09,
                delta_fairness=True)


def shard_problem(K, P, seed=0):
    from repro_torch.core.plans import random_plan_indices

    rng = np.random.default_rng(seed)
    times = rng.uniform(1.0, 100.0, K)
    counts = rng.integers(0, 50, K).astype(np.float64)
    avail = rng.random(K) < 0.8
    n_sel = max(2, int(avail.sum()) // 4)
    return times, counts, avail, n_sel, random_plan_indices(rng, avail,
                                                            n_sel, P)


def rel_diff(a, b):
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-12)))


@pytest.mark.parametrize("form", ["dense", "index"])
@pytest.mark.parametrize("N", [1, 3, 8])
def test_cuda_sharded_scoring_matches_torch(cuda, N, form):
    """Sharded ``cuda`` scoring (kernel 2.1 once per dense block) against
    sharded ``torch`` (its plain version) on the card and on the CPU:
    within 1e-5."""
    from repro_torch.core import shard
    from repro_torch.core.plans import indices_to_plans

    times, counts, _, _, idx = shard_problem(4099, 33)
    plans = indices_to_plans(idx, 4099) if form == "dense" else idx
    cc = counts - counts.mean()
    before = sched_score.launches
    got = shard.plan_stats_sharded(times, cc, plans, form, N,
                                   executor="emulate", backend="cuda",
                                   device="cuda")
    assert sched_score.launches == before + (N if form == "dense" else 0)
    for dev in ("cuda", "cpu"):
        want = shard.plan_stats_sharded(times, cc, plans, form, N,
                                        executor="emulate", backend="torch",
                                        device=dev)
        np.testing.assert_array_equal(got[:, :2], want[:, :2])
        np.testing.assert_allclose(got[:, 2], want[:, 2], rtol=1e-5,
                                   atol=1e-5)
    score = (scoring.score_plans if form == "dense"
             else scoring.score_plan_indices)
    a = score(times, counts, plans, backend="cuda", num_shards=N,
              device="cuda", **SHARD_KW)
    b = score(times, counts, plans, backend="numpy", **SHARD_KW)
    assert rel_diff(a, b) < 1e-5


def test_hash_draws_on_card_equal_cpu(cuda):
    """The BODS candidates' counter-based draws are the CPU's bit for
    bit."""
    from repro_torch.core import search

    ids = torch.arange(0, 4096, 7, dtype=torch.int64)
    for stream in (1, 2, 3, 4):
        a = search.hash_bits(2**31 - 2, stream, ids, 1001)
        b = search.hash_bits(2**31 - 2, stream, ids.to(cuda), 1001)
        assert torch.equal(a, b.cpu())
        assert torch.equal(search.hash_uniform(5, stream, ids, 257),
                           search.hash_uniform(5, stream, ids.to(cuda),
                                               257).cpu())


def test_sharded_searches_on_one_card_named_four_times(cuda):
    """SA, GA and BODS split over ``[cuda] * 4`` decide as the single lane
    on the card; BODS launches 2.1 once per block."""
    from repro_torch.core import search
    from repro_torch.core.devices import DevicePool

    K, n_sel = 400, 12
    pool = DevicePool.heterogeneous(K, 2, seed=1)
    rng = np.random.default_rng(1)
    counts = rng.integers(0, 8, K).astype(np.float64)
    avail = np.ones(K, bool)
    avail[rng.choice(K, K // 5, replace=False)] = False
    times = pool.expected_times(0, 5.0).astype(np.float32)
    devs = [cuda] * 4
    for fn, knobs in ((search.sa_search, dict(steps=30, chains=8, t0=1.0,
                                              cooling=0.97)),
                      (search.ga_search, dict(population=16, generations=5,
                                              mutation_rate=0.3))):
        one = fn(np.random.default_rng(0), times, counts, avail, n_sel,
                 **SHARD_KW, **knobs, device="cuda")
        got = fn(np.random.default_rng(0), times, counts, avail, n_sel,
                 **SHARD_KW, **knobs, device="cuda", num_shards=4,
                 devices=devs)
        np.testing.assert_array_equal(got, one)
    L = 16
    F = np.abs(rng.normal(size=(L, 6))).astype(np.float32) * 0.3
    valid = (rng.random(L) < 0.6).astype(np.float32)
    y = rng.normal(5.0, 1.0, L).astype(np.float32) * valid
    base = np.zeros(K, bool)
    base[np.flatnonzero(avail)[:n_sel]] = True
    kw = dict(F=F, y=y, est=y * 0.9, valid=valid, base_plan=base, **SHARD_KW,
              num_candidates=32, n_mut=8, local_search=True, gp_noise=0.25)
    args = (times, counts, avail, pool.mu, n_sel)
    one = search.bods_acquire(np.random.default_rng(3), *args,
                              device="cuda", **kw)
    before = sched_score.launches
    got = search.bods_acquire(np.random.default_rng(3), *args,
                              device="cuda", **kw, num_shards=4,
                              devices=devs)
    assert sched_score.launches == before + 4
    np.testing.assert_array_equal(got[0], one[0])
    assert got[1] == one[1]


# ---- the LM train path (ROADMAP module 10.a) ------------------------------
# Flash attention runs forward inside autograd; its backward is the autograd
# of the plain version on the saved inputs, so the kernel's gradients equal
# the plain version's bit for bit given the same cotangent. The MoE grouped
# matmul and the linear scan have no backward pass and refuse a gradient.

from repro_torch.kernels import NoKernelGradError  # noqa: E402
from repro_torch.kernels import ssm_scan as scan_k  # noqa: E402


def test_flash_under_autograd_at_a_train_shape(cuda):
    """qwen3-1.7b's attention at one microbatch of the train phase (1,
    4096, 16/8 heads of 128, bf16): the forward within the bf16 tolerance
    of the plain version, the wgmma variant launched once, the gradients
    of q, k and v equal to the plain version's autograd."""
    g = torch.Generator(device=cuda).manual_seed(23)
    shapes = ((1, 4096, 16, 128), (1, 4096, 8, 128), (1, 4096, 8, 128))
    leaves = [randn(g, s, torch.bfloat16).requires_grad_() for s in shapes]
    cot = torch.randn((1, 4096, 16, 128), device=cuda, generator=g)
    before = dict(fa.launches_by_variant)
    out = fa.flash_attention(*leaves)
    assert fa.launches_by_variant["wgmma"] == before["wgmma"] + 1
    (out.float() * cot).sum().backward()
    plain = [t.detach().clone().requires_grad_() for t in leaves]
    exp = fa.attention_ref(*plain)
    (exp.float() * cot).sum().backward()
    tol = ATTN_TOL[torch.bfloat16][0]
    np.testing.assert_allclose(out.detach().float().cpu(),
                               exp.detach().float().cpu(), atol=tol, rtol=tol)
    for a, b in zip(leaves, plain):
        assert torch.equal(a.grad, b.grad)


def test_kernels_without_backward_refuse_gradients(cuda):
    g = torch.Generator(device=cuda).manual_seed(24)
    xg = randn(g, (2, 64, 128), torch.bfloat16)
    wg = randn(g, (2, 128, 64), torch.bfloat16).requires_grad_()
    with pytest.raises(NoKernelGradError, match="moe_gmm.*no VJP"):
        gmm.moe_gmm(xg, wg)
    with torch.no_grad():
        gmm.moe_gmm(xg, wg)        # inference launches as before
    gmm.moe_gmm(xg, wg.detach())   # nothing needs a gradient
    q = randn(g, (1, 128, 2, 32), torch.bfloat16).requires_grad_()
    k, v = randn(g, (1, 128, 2, 32), torch.bfloat16), randn(
        g, (1, 128, 2, 32), torch.bfloat16)
    a = torch.rand((1, 128, 2), device=cuda, generator=g) * 0.5 + 0.5
    with pytest.raises(NoKernelGradError, match="linear_scan.*no VJP"):
        scan_k.linear_scan(q, k, v, a)
    with torch.inference_mode():
        scan_k.linear_scan(q, k, v, a)
    # the CPU's plain path still differentiates
    y, _ = scan_k.linear_scan(q.detach().cpu().float().requires_grad_(),
                              k.cpu().float(), v.cpu().float(), a.cpu())
    y.sum().backward()


@pytest.mark.parametrize("arch", ["dbrx-132b", "hymba-1.5b", "xlstm-350m"])
def test_train_step_through_kernels_without_backward_raises(cuda, arch):
    """A reduced MoE, hybrid or SSM train step on the card raises under
    the kernels and trains under the plain versions."""
    import importlib

    from repro_torch.config.base import ShapeConfig, TrainConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import REDUCED_MODULES
    from repro_torch.launch.steps import make_train_step, synth_batch
    from repro_torch.models.transformer import lm_init

    cfg = importlib.import_module(REDUCED_MODULES[arch]).reduced()
    step, opt_init = make_train_step(cfg, TrainConfig())
    params = lm_init(cfg, seed=0, device=cuda)
    batch = synth_batch(cfg, ShapeConfig("t", 32, 2, "train"), device=cuda)
    with pytest.raises(NoKernelGradError, match='impl="ref"'):
        step(params, opt_init(params), batch)
    ops.set_default_impl("ref")
    try:
        _, _, m = step(params, opt_init(params), batch)
    finally:
        ops.set_default_impl("cuda")
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0


@pytest.mark.parametrize("seed", range(20))
def test_scatter_add_crowded_position_many_seeds(cuda, seed):
    """The edge stream "every entry on one position" (10 x 3,000 randn
    entries onto one float, the atomic variant) on 20 seeds, within 1e-5
    relative plus absolute of the plain version."""
    g = torch.Generator(device=cuda).manual_seed(7700 + seed)
    vals = torch.randn((10, 3000), device=cuda, generator=g)
    w = torch.rand(10, device=cuda, generator=g) + 0.1
    idx = torch.full((10, 3000), T + 77, dtype=torch.int64, device=cuda)
    assert sa.kernel_variant(10, 3000, 4 * T) == "atomic"
    check_scatter(vals, idx, w, 4 * T)
