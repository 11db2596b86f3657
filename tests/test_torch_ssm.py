"""The port's gated linear recurrence and SSM blocks against the
reference's on the CPU: the scan's plain versions against
``repro.kernels.ref`` (chunked and sequential) and the Pallas kernel in
interpret mode, the decode step, and the SSD heads, mLSTM and sLSTM blocks
of ``repro.models.ssm`` at hymba-1.5b's and xlstm-350m's reduced configs.

The same numpy inputs and params go to both packages. Tolerances: the
reference kernel tests' 2e-4 for the scans (tests/test_kernels_ssm.py);
1e-5 for the decode step and the blocks in float32, where both packages
compute the same math and sum in another order.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import hymba_1p5b as ref_hymba  # noqa: E402
from repro.configs import xlstm_350m as ref_xlstm  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro.kernels.ssm_scan import linear_scan as pallas_scan  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro_torch.configs import hymba_1p5b, xlstm_350m  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssm_scan as ss  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

SCAN_CASES = [  # B, S, H, Dk, Dv, decay range
    (2, 128, 2, 16, 32, (0.6, 1.0)),      # tests/test_kernels_ssm.py:10-15
    (1, 256, 4, 32, 64, (0.6, 1.0)),
    (2, 64, 1, 8, 8, (0.6, 1.0)),
    (1, 128, 3, 16, 48, (0.6, 1.0)),
    (1, 333, 2, 8, 24, (0.5, 1.0)),       # S odd: chunks of 1 in the ref
    (2, 200, 2, 8, 16, (0.01, 0.2)),      # strong decay
]
SCAN_TOL = 2e-4
F32_TOL = 1e-5


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


def scan_inputs(B, S, H, Dk, Dv, lo, hi, seed):
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(0, 1, (B, S, H, Dk)),
              rng.normal(0, 0.5, (B, S, H, Dk)),
              rng.normal(0, 1, (B, S, H, Dv)), rng.uniform(lo, hi, (B, S, H))]
    arrays = [a.astype(np.float32) for a in arrays]
    return ([jnp.asarray(a) for a in arrays],
            [torch.as_tensor(a) for a in arrays])


# ---- the scan ----

@pytest.mark.parametrize("B,S,H,Dk,Dv,decay", SCAN_CASES)
def test_scan_plain_matches_reference(B, S, H, Dk, Dv, decay):
    (jq, jk, jv, ja), (q, k, v, a) = scan_inputs(B, S, H, Dk, Dv, *decay,
                                                 seed=S + Dk)
    ye, (Se, ne) = ref.linear_scan(jq, jk, jv, ja)
    yc, (Sc, nc) = ref.linear_scan_chunked(jq, jk, jv, ja)
    before = ss.launches
    got, (Sg, ng) = ss.linear_scan(q, k, v, a)     # CPU: the chunked form
    assert ss.launches == before
    assert bool(torch.isfinite(got).all())
    for g, e in ((got, ye), (Sg, Se), (ng, ne)):
        close(g, e, SCAN_TOL)
    for g, e in ((got, yc), (Sg, Sc), (ng, nc)):
        close(g, e, SCAN_TOL)
    y_seq, (S_seq, n_seq) = ss.linear_scan_ref(q, k, v, a)
    for g, e in ((y_seq, ye), (S_seq, Se), (n_seq, ne)):
        close(g, e, SCAN_TOL)
    # the closed-form final state the kernel path returns
    S_f, n_f = ss.final_state(k, v, a)
    close(S_f, Se, SCAN_TOL)
    close(n_f, ne, SCAN_TOL)


@pytest.mark.parametrize("B,S,H,Dk,Dv,chunk", [(2, 128, 2, 16, 32, 32),
                                               (1, 128, 3, 16, 48, 128)])
def test_scan_plain_matches_pallas_interpret(B, S, H, Dk, Dv, chunk):
    (jq, jk, jv, ja), (q, k, v, a) = scan_inputs(B, S, H, Dk, Dv, 0.6, 1.0,
                                                 seed=chunk)
    ye, (Se, ne) = pallas_scan(jq, jk, jv, ja, chunk=chunk, interpret=True)
    got, (Sg, ng) = ops.linear_scan(q, k, v, a, impl="ref")
    for g, e in ((got, ye), (Sg, Se), (ng, ne)):
        close(g, e, SCAN_TOL)


def test_scan_strided_views_and_no_final_state():
    """q and k sliced out of one projection (as the models do), and the
    final state left out when not asked for."""
    (_, _, jv, ja), (_, _, v, a) = scan_inputs(2, 64, 2, 8, 16, 0.6, 1.0, 1)
    qk = np.random.default_rng(2).normal(0, 0.5, (2, 64, 2, 16)).astype(
        np.float32)
    exp, _ = ref.linear_scan(jnp.asarray(qk[..., 8:]),
                             jnp.asarray(qk[..., :8]), jv, ja)
    tqk = torch.as_tensor(qk)
    got, state = ops.linear_scan(tqk[..., 8:], tqk[..., :8], v, a,
                                 want_final_state=False)
    assert state is None
    close(got, exp, SCAN_TOL)


def test_scan_bf16_inputs():
    (jq, jk, jv, ja), (q, k, v, a) = scan_inputs(1, 96, 2, 16, 32, 0.6, 1.0, 4)
    exp, _ = ref.linear_scan_chunked(jq.astype(jnp.bfloat16),
                                     jk.astype(jnp.bfloat16),
                                     jv.astype(jnp.bfloat16), ja)
    got, _ = ss.linear_scan(q.bfloat16(), k.bfloat16(), v.bfloat16(), a)
    assert got.dtype == torch.bfloat16
    close(got, exp.astype(jnp.float32), 2e-2)


def test_decode_step_continues_prefill():
    """The scan's final state plus one step == the oracle over S + 1
    (tests/test_kernels_ssm.py:61-76), and the step matches the
    reference's step from the same state."""
    B, S, H, Dk, Dv = 2, 64, 2, 8, 16
    rng = np.random.default_rng(9)
    arrays = [rng.normal(0, 0.5, s).astype(np.float32) for s in
              ((B, S + 1, H, Dk), (B, S + 1, H, Dk), (B, S + 1, H, Dv))]
    arrays.append(rng.uniform(0.6, 1.0, (B, S + 1, H)).astype(np.float32))
    jq, jk, jv, ja = (jnp.asarray(x) for x in arrays)
    q, k, v, a = (torch.as_tensor(x) for x in arrays)
    y_all, _ = ref.linear_scan(jq, jk, jv, ja)
    _, state = ss.linear_scan(q[:, :S], k[:, :S], v[:, :S], a[:, :S])
    y_step, (St, nt) = ops.linear_scan_step(q[:, S], k[:, S], v[:, S],
                                            a[:, S], state)
    close(y_step, y_all[:, S], SCAN_TOL)
    ref_state = (jnp.asarray(state[0].numpy()), jnp.asarray(state[1].numpy()))
    ye, (Se, ne) = ref.linear_scan_step(jq[:, S], jk[:, S], jv[:, S],
                                        ja[:, S], ref_state)
    for g, e in ((y_step, ye), (St, Se), (nt, ne)):
        close(g, e, F32_TOL)
    # the sequential form from an initial state
    y2, _ = ops.linear_scan(q[:, S:], k[:, S:], v[:, S:], a[:, S:],
                            init_state=state, impl="ref")
    close(y2[:, 0], ye, F32_TOL)


# ---- the blocks ----

def pair(mod_ref, mod, init, seed=0):
    ref_cfg, cfg = mod_ref.reduced(), mod.reduced()
    ref_p, _ = getattr(ref_ssm, init)(ref_cfg, np.random.default_rng(seed))
    p = getattr(ssm, init)(cfg, np.random.default_rng(seed))
    for name in ref_p:
        np.testing.assert_array_equal(np.asarray(ref_p[name]),
                                      p[name].numpy())
    return ref_cfg, cfg, ref_p, p


BLOCKS = [  # (reference config module, port config module, block)
    (ref_hymba, hymba_1p5b, "ssd"),
    (ref_xlstm, xlstm_350m, "mlstm"),
    (ref_xlstm, xlstm_350m, "slstm"),
]


def decode_state(name, cfg, B, ref=False):
    fn = getattr(ref_ssm if ref else ssm, f"{name}_decode_state")
    if name == "slstm":
        return fn(cfg, B, jnp.float32) if ref else fn(cfg, B, torch.float32,
                                                      device="cpu")
    return fn(cfg, B) if ref else fn(cfg, B, device="cpu")


@pytest.mark.parametrize("mod_ref,mod,name", BLOCKS)
def test_block_apply_matches_reference(mod_ref, mod, name):
    ref_cfg, cfg, ref_p, p = pair(mod_ref, mod, f"{name}_init")
    x = np.random.default_rng(1).normal(0, 1, (2, 24, cfg.d_model)).astype(
        np.float32)
    exp = getattr(ref_ssm, f"{name}_apply")(ref_cfg, ref_p, jnp.asarray(x))
    got = getattr(ssm, f"{name}_apply")(cfg, p, torch.as_tensor(x))
    assert got.shape == x.shape
    close(got, exp, F32_TOL)


@pytest.mark.parametrize("mod_ref,mod,name", BLOCKS)
def test_block_decode_matches_reference(mod_ref, mod, name):
    """Four steps from the zero state, then the last state compared."""
    ref_cfg, cfg, ref_p, p = pair(mod_ref, mod, f"{name}_init", seed=3)
    ref_state = decode_state(name, ref_cfg, 3, ref=True)
    state = decode_state(name, cfg, 3)
    rng = np.random.default_rng(4)
    for _ in range(4):
        x = rng.normal(0, 1, (3, 1, cfg.d_model)).astype(np.float32)
        exp, ref_state = getattr(ref_ssm, f"{name}_decode")(
            ref_cfg, ref_p, jnp.asarray(x), ref_state)
        got, state = getattr(ssm, f"{name}_decode")(cfg, p,
                                                    torch.as_tensor(x), state)
        close(got, exp, F32_TOL)
    for g, e in zip(state, ref_state):
        close(g, e, F32_TOL)


@pytest.mark.parametrize("mod_ref,mod,name", BLOCKS)
def test_block_decode_continues_apply(mod_ref, mod, name):
    """Decoding token by token gives the prefill's outputs (the port's
    own consistency, on the port alone)."""
    _, cfg, _, p = pair(mod_ref, mod, f"{name}_init", seed=5)
    x = torch.as_tensor(np.random.default_rng(6).normal(
        0, 1, (2, 12, cfg.d_model)).astype(np.float32))
    full = getattr(ssm, f"{name}_apply")(cfg, p, x)
    state = decode_state(name, cfg, 2)
    for t in range(x.shape[1]):
        y, state = getattr(ssm, f"{name}_decode")(cfg, p, x[:, t:t + 1],
                                                  state)
        close(y[:, 0], full[:, t].numpy(), SCAN_TOL)


def test_mlstm_key_scale_rounds_in_bf16():
    """k / sqrt(dh) divides by sqrt(dh) rounded to the compute dtype, as
    the reference forms it: 22.625 for dh = 512 in bf16."""
    assert float(jnp.sqrt(jnp.asarray(512, jnp.bfloat16))) == 22.625
    cfg = dataclasses.replace(xlstm_350m.reduced(), d_model=512, num_heads=2,
                              dtype="bfloat16")
    p = ssm.mlstm_init(cfg, np.random.default_rng(0))
    x = torch.as_tensor(np.random.default_rng(1).normal(
        0, 1, (1, 4, 512)).astype(np.float32)).bfloat16()
    _, k, *_ = ssm._mlstm_qkvg(cfg, p, x)
    qk = (x @ p["w_qk"].bfloat16()).reshape(1, 4, 2, 1024)
    gates = (x @ p["w_if"].bfloat16()).float()
    i_gate = torch.exp(torch.clamp(gates[..., :2], max=8.0))
    exp = (qk[..., 512:] / torch.tensor(22.625, dtype=torch.bfloat16)
           * i_gate[..., None].bfloat16())
    assert torch.equal(k, exp)


# ---- the chunk-parallel kernel's plan (host side) ----

@pytest.mark.parametrize("shape,chunk,scratch_mb", [
    ((2, 4096, 25, 16, 128), 64, 26.4),      # hymba-1.5b's SSD heads
    ((1, 1024, 4, 512, 512), 128, 33.6),     # xlstm-350m's mLSTM
    ((2, 4096, 4, 512, 512), 128, 269.0),
    ((1, 333, 3, 16, 128), 64, 0.149),
    ((2, 200, 2, 8, 16), 64, 0.0087),
])
def test_scan_plan_covers_the_sequence(shape, chunk, scratch_mb):
    B, S, H, Dk, Dv = shape
    L, nC, n_states, n_al = ss.scan_plan(*shape)
    assert L == chunk == ss.chunk_length(Dk, Dv) and L in ss.CHUNKS
    assert nC * L >= S > (nC - 1) * L
    assert n_states == B * H * nC * (Dk * Dv + Dk) and n_al == B * H * nC
    assert abs(n_states * 4 / 1e6 - scratch_mb) <= 0.05 * scratch_mb
    for L2 in ss.CHUNKS:   # either length serves any shape
        assert ss.scan_plan(*shape, chunk=L2)[1] == -(-S // L2)
    with pytest.raises(ValueError):
        ss.scan_plan(*shape, chunk=96)
