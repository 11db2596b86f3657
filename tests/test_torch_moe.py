"""The port's MoE path against the reference's on the CPU: the grouped
matmul's plain version (``repro.kernels.ref.moe_gmm`` and the Pallas
kernel in interpret mode) and the MoE block (``repro.models.moe``) at
dbrx-132b's and kimi-k2's reduced configs.

The same numpy inputs and params go to both packages. Tolerances: the
reference kernel tests' 1e-4 in float32 and 2e-2 in bfloat16
(tests/test_kernels_moe.py). The block holds 1e-5 in float32 (both
packages sum the same products in another order; routing is identical,
expert ids compared exactly), and 2e-2 plus the agreeing routing share in
bfloat16, where a bf16 router logit near a tie can pick another expert in
the other framework.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import dbrx_132b as ref_dbrx  # noqa: E402
from repro.configs import kimi_k2_1t_a32b as ref_kimi  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro.kernels.moe_gmm import moe_gmm as pallas_gmm  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro_torch.configs import dbrx_132b, kimi_k2_1t_a32b  # noqa: E402
from repro_torch.kernels import moe_gmm as gmm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import moe  # noqa: E402

CASES = [  # E, C, din, dout  (tests/test_kernels_moe.py:10-16)
    (4, 96, 192, 320),
    (2, 128, 256, 256),
    (8, 64, 128, 512),
    (1, 256, 512, 128),
    (3, 100, 130, 70),
]
GMM_F32_TOL = 1e-4
GMM_BF16_TOL = 2e-2
BLOCK_F32_TOL = 1e-5
BLOCK_BF16_TOL = 2e-2
CONFIGS = {"dbrx-132b": (ref_dbrx, dbrx_132b),
           "kimi-k2-1t-a32b": (ref_kimi, kimi_k2_1t_a32b)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs several test files at once, and
    the timing-sensitive tests of other files must not be starved."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def close(got, exp, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(exp, np.float32), atol=tol, rtol=tol)


# ---- grouped matmul ----

@pytest.mark.parametrize("E,C,din,dout", CASES)
def test_gmm_plain_matches_reference(E, C, din, dout):
    rng = np.random.default_rng(E * 1000 + C)
    x = rng.normal(0, 1, (E, C, din)).astype(np.float32)
    w = rng.normal(0, 0.05, (E, din, dout)).astype(np.float32)
    exp = ref.moe_gmm(jnp.asarray(x), jnp.asarray(w))
    before = gmm.launches
    got = gmm.moe_gmm(torch.as_tensor(x), torch.as_tensor(w))
    assert gmm.launches == before  # CPU tensors take the plain version
    assert got.dtype == torch.float32 and got.shape == (E, C, dout)
    close(got, exp, GMM_F32_TOL)
    close(ops.moe_gmm(torch.as_tensor(x), torch.as_tensor(w), impl="ref"),
          exp, GMM_F32_TOL)


@pytest.mark.parametrize("E,C,din,dout", [CASES[0], CASES[4]])
def test_gmm_plain_matches_pallas_interpret(E, C, din, dout):
    rng = np.random.default_rng(7)
    x = rng.normal(0, 1, (E, C, din)).astype(np.float32)
    w = rng.normal(0, 0.05, (E, din, dout)).astype(np.float32)
    exp = pallas_gmm(jnp.asarray(x), jnp.asarray(w), interpret=True)
    close(gmm.moe_gmm(torch.as_tensor(x), torch.as_tensor(w)), exp,
          GMM_F32_TOL)


def test_gmm_bf16():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (4, 96, 192)).astype(np.float32)
    w = rng.normal(0, 0.05, (4, 192, 320)).astype(np.float32)
    got = gmm.moe_gmm(torch.as_tensor(x).bfloat16(),
                      torch.as_tensor(w).bfloat16())
    assert got.dtype == torch.bfloat16
    exp = ref.moe_gmm(jnp.asarray(x, jnp.bfloat16),
                      jnp.asarray(w, jnp.bfloat16))
    close(got, exp.astype(jnp.float32), GMM_BF16_TOL)


def test_gmm_rejects_bad_inputs():
    x = torch.zeros((2, 3, 4))
    with pytest.raises(TypeError):
        gmm.moe_gmm(x, torch.zeros((2, 5, 6)))
    with pytest.raises(TypeError):
        gmm.moe_gmm(x, torch.zeros((2, 4, 6), dtype=torch.float64))
    with pytest.raises(TypeError):
        gmm.moe_gmm(x, torch.zeros((2, 4, 6)).bfloat16())


# ---- the MoE block ----

def block_pair(arch, dtype="float32", seed=0):
    """(ref cfg, port cfg, ref params, port params) of ``arch``'s reduced
    config, the params drawn once with numpy."""
    ref_mod, mod = CONFIGS[arch]
    ref_cfg = dataclasses.replace(ref_mod.reduced(), dtype=dtype)
    cfg = dataclasses.replace(mod.reduced(), dtype=dtype)
    ref_p, _ = ref_moe.moe_init(ref_cfg, np.random.default_rng(seed))
    p = moe.moe_init(cfg, np.random.default_rng(seed))
    for name in ref_p:
        np.testing.assert_array_equal(np.asarray(ref_p[name]),
                                      p[name].numpy())
    return ref_cfg, cfg, ref_p, p


def ref_route(ref_cfg, ref_p, x):
    """The reference's routing (moe.py:126-129) on (T, d) tokens."""
    logits = (x @ ref_p["router"].astype(x.dtype)).astype(jnp.float32)
    w, ids = jax.lax.top_k(jax.nn.softmax(logits, -1),
                           ref_cfg.experts_per_token)
    return w / jnp.maximum(w.sum(-1, keepdims=True), 1e-9), ids


def run_block(ref_cfg, cfg, ref_p, p, x, dtype):
    """Both blocks on x (B, S, d): (ref out, port out, ref ids, port ids)."""
    jx = jnp.asarray(x, JDT[dtype])
    tx = torch.as_tensor(x).to(TDT[dtype])
    exp = ref_moe._moe_local(ref_cfg, ref_p, jx, 0, ref_cfg.num_experts)
    got = moe.moe_apply(cfg, p, tx)
    assert got.dtype == TDT[dtype] and got.shape == tx.shape
    d = x.shape[-1]
    _, exp_ids = ref_route(ref_cfg, ref_p, jx.reshape(-1, d))
    _, ids = moe.route(cfg, p, tx.reshape(-1, d))
    return exp, got, np.asarray(exp_ids), ids.numpy()


@pytest.mark.parametrize("arch", list(CONFIGS))
@pytest.mark.parametrize("shape", [(2, 16), (1, 1), (3, 5)])
def test_moe_block_matches_reference_f32(arch, shape):
    ref_cfg, cfg, ref_p, p = block_pair(arch)
    x = np.random.default_rng(sum(shape)).normal(
        0, 1, shape + (cfg.d_model,)).astype(np.float32)
    exp, got, exp_ids, ids = run_block(ref_cfg, cfg, ref_p, p, x, "float32")
    np.testing.assert_array_equal(ids, exp_ids)
    close(got, exp, BLOCK_F32_TOL)


@pytest.mark.parametrize("arch", list(CONFIGS))
def test_moe_block_bf16(arch):
    ref_cfg, cfg, ref_p, p = block_pair(arch, "bfloat16")
    x = np.random.default_rng(3).normal(0, 1, (2, 16, cfg.d_model))
    exp, got, exp_ids, ids = run_block(ref_cfg, cfg, ref_p, p,
                                       x.astype(np.float32), "bfloat16")
    agree = (np.sort(ids, -1) == np.sort(exp_ids, -1)).all(-1)
    assert agree.mean() >= 0.9
    # tokens routed alike hold the bf16 tolerance
    close(got.reshape(-1, cfg.d_model)[torch.as_tensor(agree)],
          np.asarray(exp.astype(jnp.float32)).reshape(-1, cfg.d_model)[agree],
          BLOCK_BF16_TOL)


@pytest.mark.parametrize("arch", list(CONFIGS))
def test_moe_forced_tie_takes_lower_expert(arch):
    """Experts 1 and 2 get identical router columns, so every token ties
    them; lax.top_k takes the lower id first, and so must the port."""
    ref_cfg, cfg, ref_p, p = block_pair(arch)
    router = np.asarray(ref_p["router"]).copy()
    router[:, 2] = router[:, 1]
    router[:, 1] += 0.5   # push the tied pair into the top-k
    router[:, 2] += 0.5
    ref_p = dict(ref_p, router=jnp.asarray(router))
    p = dict(p, router=torch.as_tensor(router))
    x = np.random.default_rng(4).normal(0, 1, (2, 8, cfg.d_model)).astype(
        np.float32)
    exp, got, exp_ids, ids = run_block(ref_cfg, cfg, ref_p, p, x, "float32")
    tied = (exp_ids == 1).any(-1) & (exp_ids == 2).any(-1)
    assert tied.any()
    np.testing.assert_array_equal(ids, exp_ids)
    close(got, exp, BLOCK_F32_TOL)


@pytest.mark.parametrize("arch", list(CONFIGS))
def test_moe_capacity_overflow_drops_alike(arch):
    """Every token's first pick is expert 0, far more than its C slots:
    the picks past capacity are dropped (weight 0) in both."""
    ref_cfg, cfg, ref_p, p = block_pair(arch)
    router = np.asarray(ref_p["router"]).copy()
    router[:, 0] = 0.0
    router[0, 0] = 10.0     # expert 0's logit is 10 x[0] = 500 for all
    ref_p = dict(ref_p, router=jnp.asarray(router))
    p = dict(p, router=torch.as_tensor(router))
    x = np.random.default_rng(5).normal(0, 1, (2, 16, cfg.d_model)).astype(
        np.float32)
    x[..., 0] = 50.0
    exp, got, exp_ids, ids = run_block(ref_cfg, cfg, ref_p, p, x, "float32")
    assert (ids[:, 0] == 0).all()
    assert ids.shape[0] > moe.capacity(cfg, ids.shape[0])
    np.testing.assert_array_equal(ids, exp_ids)
    close(got, exp, BLOCK_F32_TOL)
