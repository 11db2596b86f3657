"""The port's attention kernels' plain versions against the reference's
oracles (``repro.kernels.ref``) and, for a few cases, the Pallas kernels in
interpret mode, on the CPU.

The same numpy inputs go to both packages. Tolerances are the reference's
kernel tests' (tests/test_kernels_flash.py, tests/test_kernels_decode.py):
2e-5 in float32, 2e-2 for flash and 3e-2 for decode in bfloat16 (the two
frameworks round bf16 products and sums at other places), 5e-4 for the
flash gradient. On CPU tensors the wrappers (``flash_attention``,
``decode_attention``) are the plain versions; the kernels themselves run in
tests/test_torch_cuda.py on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro.kernels.decode_attention import decode_attention as pallas_decode  # noqa: E402
from repro.kernels.flash_attention import flash_attention as pallas_flash  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

FLASH_CASES = [
    # B, S, H, KV, D, causal, window  (tests/test_kernels_flash.py:11-19)
    (2, 128, 4, 2, 64, True, None),
    (1, 256, 8, 8, 32, True, None),
    (2, 128, 4, 1, 64, True, 64),
    (1, 64, 2, 2, 128, False, None),
    (1, 192, 6, 3, 64, True, None),
    (3, 64, 4, 4, 16, True, 16),
    (2, 100, 10, 2, 16, True, 24),    # S not a power of two, G = 5
    (1, 96, 4, 2, 32, False, 20),     # window without causal
    # D = 256 (paligemma-3b's head dim; wgmma with 64-key tiles on the
    # card): causal MQA, and windowed GQA with S not a multiple of 64
    (1, 96, 8, 1, 256, True, None),
    (2, 72, 4, 2, 256, True, 32),
]
DECODE_CASES = [
    # B, H, KV, D, T  (tests/test_kernels_decode.py:10-15)
    (2, 4, 2, 64, 128),
    (3, 8, 1, 32, 256),
    (2, 8, 8, 128, 64),
    (1, 16, 4, 64, 512),
    (4, 16, 1, 16, 100),              # MQA, T not a power of two
]
F32_TOL = 2e-5
FLASH_BF16_TOL = 2e-2
DECODE_BF16_TOL = 3e-2
GRAD_TOL = 5e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs several test files at once, and
    the timing-sensitive tests of other files must not be starved."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def draw(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, s).astype(np.float32) for s in shapes]


def both(arrays, dtype):
    """numpy arrays -> (jnp arrays, torch tensors) in ``dtype``."""
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.as_tensor(a).to(tdt) for a in arrays])


def close(got, exp, tol):
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(exp, np.float32), atol=tol,
                               rtol=tol)


# ---- flash attention (prefill) ----

@pytest.mark.parametrize("B,S,H,KV,D,causal,window", FLASH_CASES)
def test_attention_ref_matches_reference(B, S, H, KV, D, causal, window):
    arrays = draw(B * 1000 + S, (B, S, H, D), (B, S, KV, D), (B, S, KV, D))
    (jq, jk, jv), (q, k, v) = both(arrays, "float32")
    exp = ref.attention(jq, jk, jv, causal=causal, window=window)
    close(fa.attention_ref(q, k, v, causal=causal, window=window), exp,
          F32_TOL)
    close(fa.attention_dense_ref(q, k, v, causal=causal, window=window),
          ref.attention_dense(jq, jk, jv, causal=causal, window=window),
          F32_TOL)
    close(fa.flash_attention(q, k, v, causal=causal, window=window), exp,
          F32_TOL)


@pytest.mark.parametrize("B,S,H,KV,D,causal,window", FLASH_CASES[:6])
def test_attention_ref_bf16(B, S, H, KV, D, causal, window):
    arrays = draw(7 + S, (B, S, H, D), (B, S, KV, D), (B, S, KV, D))
    (jq, jk, jv), (q, k, v) = both(arrays, "bfloat16")
    got = fa.attention_ref(q, k, v, causal=causal, window=window)
    assert got.dtype == torch.bfloat16
    close(got, ref.attention(jq, jk, jv, causal=causal, window=window)
          .astype(jnp.float32), FLASH_BF16_TOL)


@pytest.mark.parametrize("case,blk", [(FLASH_CASES[0], 64),
                                      (FLASH_CASES[2], 64),
                                      (FLASH_CASES[5], 16)])
def test_attention_ref_matches_pallas_interpret(case, blk):
    B, S, H, KV, D, causal, window = case
    arrays = draw(11, (B, S, H, D), (B, S, KV, D), (B, S, KV, D))
    (jq, jk, jv), (q, k, v) = both(arrays, "float32")
    exp = pallas_flash(jq, jk, jv, causal=causal, window=window,
                       block_q=blk, block_k=blk, interpret=True)
    close(fa.flash_attention(q, k, v, causal=causal, window=window), exp,
          F32_TOL)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 24),
                                           (False, None)])
def test_flash_gradient_matches_reference_vjp(causal, window):
    """The port's autograd.Function (plain forward on the CPU, backward
    through ``attention_ref``) against the reference's custom_vjp."""
    arrays = draw(1, (1, 64, 4, 32), (1, 64, 2, 32), (1, 64, 2, 32))
    (jq, jk, jv), (q, k, v) = both(arrays, "float32")

    def f_ref(q_, k_, v_):
        return (pallas_flash(q_, k_, v_, causal=causal, window=window,
                             block_q=32, block_k=32, interpret=True)
                ** 2).sum()

    exp = jax.grad(f_ref, argnums=(0, 1, 2))(jq, jk, jv)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    (fa.flash_attention(*leaves, causal=causal, window=window) ** 2
     ).sum().backward()
    for t, e in zip(leaves, exp):
        close(t.grad, e, GRAD_TOL)


# kimi-k2's head dim of 112 (64/8 heads at full width), at a small size:
# the plain versions against the reference's Pallas kernels in interpret
# mode (``repro.kernels.ops``, impl="interpret")
D112_FLASH = [(1, 64, 8, 1, True, None), (2, 48, 4, 2, True, 16),
              (1, 40, 4, 4, False, None)]


@pytest.mark.parametrize("B,S,H,KV,causal,window", D112_FLASH)
def test_attention_ref_at_d112_matches_pallas_interpret(B, S, H, KV, causal,
                                                        window):
    D = 112
    arrays = draw(112 + S, (B, S, H, D), (B, S, KV, D), (B, S, KV, D))
    (jq, jk, jv), (q, k, v) = both(arrays, "float32")
    exp = ref_ops.attention(jq, jk, jv, causal=causal, window=window,
                            impl="interpret")
    close(fa.attention_ref(q, k, v, causal=causal, window=window), exp,
          F32_TOL)
    close(fa.flash_attention(q, k, v, causal=causal, window=window), exp,
          F32_TOL)


@pytest.mark.parametrize("B,H,KV,T,length", [(2, 8, 1, 64, [1, 64]),
                                             (3, 8, 2, 100, [0, 37, 100])])
def test_decode_ref_at_d112_matches_pallas_interpret(B, H, KV, T, length):
    D = 112
    arrays = draw(212 + T, (B, H, D), (B, T, KV, D), (B, T, KV, D))
    lengths = np.array(length, np.int32)
    (jq, jk, jv), (q, k, v) = both(arrays, "float32")
    exp = ref_ops.decode_attention(jq, jk, jv, jnp.asarray(lengths),
                                   impl="interpret")
    lt = torch.as_tensor(lengths)
    close(da.decode_attention_ref(q, k, v, lt), exp, F32_TOL)
    close(da.decode_attention(q, k, v, lt), exp, F32_TOL)


# ---- decode attention ----

@pytest.mark.parametrize("B,H,KV,D,T", DECODE_CASES)
def test_decode_ref_matches_reference(B, H, KV, D, T):
    arrays = draw(B * 100 + T, (B, H, D), (B, T, KV, D), (B, T, KV, D))
    length = np.random.default_rng(T).integers(1, T + 1, (B,)).astype(
        np.int32)
    (jq, jk, jv), (q, k, v) = both(arrays, "float32")
    exp = ref.decode_attention(jq, jk, jv, jnp.asarray(length))
    lt = torch.as_tensor(length)
    close(da.decode_attention_ref(q, k, v, lt), exp, F32_TOL)
    close(da.decode_attention(q, k, v, lt), exp, F32_TOL)


@pytest.mark.parametrize("B,H,KV,D,T,blk", [(2, 4, 2, 64, 128, 64),
                                            (3, 8, 1, 32, 256, 64)])
def test_decode_ref_matches_pallas_interpret(B, H, KV, D, T, blk):
    arrays = draw(5, (B, H, D), (B, T, KV, D), (B, T, KV, D))
    length = np.array([1, T, T // 3][:B], np.int32)
    (jq, jk, jv), (q, k, v) = both(arrays, "float32")
    exp = pallas_decode(jq, jk, jv, jnp.asarray(length), block_k=blk,
                        interpret=True)
    close(da.decode_attention(q, k, v, torch.as_tensor(length)), exp,
          F32_TOL)


def test_decode_bf16():
    arrays = draw(7, (2, 4, 64), (2, 128, 2, 64), (2, 128, 2, 64))
    length = np.array([64, 128], np.int32)
    (jq, jk, jv), (q, k, v) = both(arrays, "bfloat16")
    got = da.decode_attention(q, k, v, torch.as_tensor(length))
    assert got.dtype == torch.bfloat16
    close(got, ref.decode_attention(jq, jk, jv, jnp.asarray(length))
          .astype(jnp.float32), DECODE_BF16_TOL)


def test_decode_length_masking_exact():
    """Rows past ``length`` have exactly no influence."""
    q, k, v = (torch.as_tensor(a) for a in draw(
        3, (1, 2, 16), (1, 64, 1, 16), (1, 64, 1, 16)))
    length = torch.tensor([17], dtype=torch.int32)
    out1 = da.decode_attention(q, k, v, length)
    k2, v2 = k.clone(), v.clone()
    k2[:, 17:] = 1e4
    v2[:, 17:] = -1e4
    out2 = da.decode_attention(q, k2, v2, length)
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), atol=1e-6)


def test_decode_length_zero_is_mean_of_v():
    """length 0 masks every logit alike: the softmax is uniform over all T
    rows, in the reference and in the port."""
    arrays = draw(9, (2, 4, 32), (2, 40, 2, 32), (2, 40, 2, 32))
    length = np.array([0, 1], np.int32)
    (jq, jk, jv), (q, k, v) = both(arrays, "float32")
    got = da.decode_attention(q, k, v, torch.as_tensor(length))
    close(got, ref.decode_attention(jq, jk, jv, jnp.asarray(length)),
          F32_TOL)
    mean_v = v[0].mean(dim=0).repeat_interleave(2, dim=0)  # (H, D)
    np.testing.assert_allclose(got[0].numpy(), mean_v.numpy(), atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(),
                               v[1, 0].repeat_interleave(2, dim=0).numpy(),
                               atol=1e-6)


# ---- dispatch and wrappers ----

def test_ops_dispatch_and_default_impl():
    q, k, v = (torch.as_tensor(a) for a in draw(
        2, (1, 32, 4, 16), (1, 32, 2, 16), (1, 32, 2, 16)))
    exp = fa.attention_ref(q, k, v)
    assert ops.get_default_impl() == "cuda"
    before = fa.launches
    for impl in ("ref", "cuda", None):
        torch.testing.assert_close(ops.attention(q, k, v, impl=impl), exp,
                                   rtol=0, atol=0)
    try:
        ops.set_default_impl("ref")
        assert ops.get_default_impl() == "ref"
        length = torch.tensor([5], dtype=torch.int32)
        torch.testing.assert_close(
            ops.decode_attention(q[:, 0], k, v, length),
            da.decode_attention_ref(q[:, 0], k, v, length), rtol=0, atol=0)
    finally:
        ops.set_default_impl("cuda")
    assert fa.launches == before  # CPU tensors never launch
    with pytest.raises(ValueError):
        ops.set_default_impl("pallas")
    with pytest.raises(ValueError):
        ops.attention(q, k, v, impl="interpret")


def test_wrappers_reject_bad_inputs():
    q = torch.zeros(1, 8, 4, 16)
    k = torch.zeros(1, 8, 3, 16)
    with pytest.raises(ValueError, match="multiple of KV"):
        fa.flash_attention(q, k, k)
    with pytest.raises(TypeError):
        fa.flash_attention(q, q.double(), q.double())
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention(q, q[:, :, :2], q[:, :, :2], window=0)
    with pytest.raises(TypeError, match="length"):
        da.decode_attention(q[:, 0], q[:, :, :2], q[:, :, :2],
                            torch.zeros(1))
    with pytest.raises(TypeError):
        da.decode_attention(q[:, 0], q[:, :, :2], q[:, :5, :2],
                            torch.zeros(1, dtype=torch.int32))


@pytest.mark.parametrize("B,KV,T", [(16, 8, 4096), (128, 8, 32768),
                                    (1, 1, 100), (2, 4, 777)])
def test_decode_split_plan_covers_the_cache(B, KV, T):
    nsplit, chunk = da.split_plan(B, KV, T)
    assert chunk % da.TILE == 0 and nsplit * chunk >= T
    assert (nsplit - 1) * chunk < T
    assert nsplit == 1 or chunk >= da.MIN_CHUNK


@pytest.mark.parametrize("B,KV,T", [(16, 8, 4096), (128, 8, 32768),
                                    (16, 5, 1024), (2, 4, 777), (1, 1, 1)])
def test_decode_simt_split_plan_covers_the_cache(B, KV, T):
    """The simt variant keeps its own plan (more, smaller splits)."""
    nsplit, chunk = da.split_plan(B, KV, T, "simt")
    assert chunk % da.TILE == 0 and nsplit * chunk >= T > (nsplit - 1) * chunk
    assert nsplit == 1 or chunk >= da.MIN_CHUNK
    assert nsplit >= da.split_plan(B, KV, T)[0]


def test_decode_split_plan_tuned_for_tma():
    """The tma variant's plan as tuned on the card: 4 splits at qwen3's and
    hymba's 16 slots, one block per (sequence, kv-head) at decode_32k."""
    assert da.split_plan(16, 8, 4096) == (4, 1024)
    assert da.split_plan(16, 5, 1024) == (4, 256)
    assert da.split_plan(128, 8, 32768) == (1, 32768)


@pytest.mark.parametrize("target,min_chunk", [(256, 256), (512, 1024),
                                              (4096, 256), (4096, 1024)])
@pytest.mark.parametrize("B,KV,T", [(16, 8, 4096), (128, 8, 32768),
                                    (16, 5, 1024), (16, 8, 777)])
def test_decode_split_plan_takes_a_target(B, KV, T, target, min_chunk):
    """The plans the tuning sweep times (scripts/tune_decode_scan.py) cover
    the cache as the shipped one does, and the defaults are the shipped
    plan."""
    nsplit, chunk = da.split_plan(B, KV, T, "tma", target, min_chunk)
    assert chunk % da.TILE == 0 and nsplit * chunk >= T > (nsplit - 1) * chunk
    assert nsplit == 1 or chunk >= min_chunk
    assert nsplit <= max(1, -(-target // (B * KV)))
    assert da.split_plan(B, KV, T, "tma", da.TARGET_BLOCKS["tma"],
                         da.MIN_CHUNK) == da.split_plan(B, KV, T)
