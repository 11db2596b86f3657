"""The port's LLM serving path against the reference's
(``repro.models.transformer``, ``repro.launch``) on the CPU, at the
``reduced()`` sizes of the four dense configs, the two MoE configs
(dbrx-132b, kimi-k2), the hybrid (hymba-1.5b), the SSM (xlstm-350m), the
audio model (musicgen-medium: frame embeddings are the sequence) and the
VLM (paligemma-3b: patch embeddings before the text). Full-width configs
are checked through ``lm_param_shapes`` (meta tensors) only.

``lm_init`` must be bit-identical (the same numpy draws, rounded to float32
once). Logits agree within a tolerance: in float32 both packages compute
the same math but sum the matmuls in another order (measured up to 2e-6 on
logits of magnitude about 6), so LOGIT_TOL_F32 is 1e-4 absolute; in
bfloat16 the two frameworks also round products and elementwise chains at
other places (XLA keeps fused chains in f32), so logits may differ by a few
bf16 ulps (0.03125 at magnitudes 4-8): LOGIT_TOL_BF16 is 0.25. The
continuous-batching loop's greedy tokens must be identical on a float32
config, slot refills included (a refilled slot keeps its recurrent state,
in both). KV caches agree within STATE_TOL; the SSD, mLSTM and sLSTM
states within STATE_TOL of each state's largest entry.
"""

import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.config.registry import get_arch as ref_get_arch  # noqa: E402
from repro.config.shapes import SHAPES as REF_SHAPES  # noqa: E402
from repro.config.shapes import shape_applicable as ref_applicable  # noqa: E402
from repro.configs import ASSIGNED_ARCHS  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import transformer as rt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import config as port_config_pkg  # noqa: E402
from repro_torch import configs as port_configs  # noqa: E402
from repro_torch.config import base as port_base  # noqa: E402
from repro_torch.config.base import AttentionKind  # noqa: E402
from repro_torch.config.shapes import SHAPES  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import transformer as pt  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

DENSE = ("qwen3-1.7b", "qwen3-8b", "glm4-9b", "deepseek-67b")
OTHERS = ("dbrx-132b", "kimi-k2-1t-a32b", "hymba-1.5b", "xlstm-350m")
FRONTEND = ("musicgen-medium", "paligemma-3b")
PORTED = DENSE + OTHERS + FRONTEND
LOGIT_TOL_F32 = 1e-4
LOGIT_TOL_BF16 = 0.25
STATE_TOL = {"float32": 1e-5, "bfloat16": 0.05}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs several test files at once, and
    the timing-sensitive tests of other files must not be starved."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def reduced_pair(arch, **changes):
    """(reference config, port config) of ``arch``'s reduced size."""
    ref_mod = importlib.import_module(
        "repro.configs." + port_serve.REDUCED_MODULES[arch].split(".")[-1])
    port_mod = importlib.import_module(port_serve.REDUCED_MODULES[arch])
    return (dataclasses.replace(ref_mod.reduced(), **changes),
            dataclasses.replace(port_mod.reduced(), **changes))


def port_config(ref_cfg):
    """The port's ModelConfig with every field of a reference config."""
    kw = {f.name: getattr(ref_cfg, f.name)
          for f in dataclasses.fields(ref_cfg)}
    kw["family"] = port_base.ArchFamily(ref_cfg.family.value)
    kw["attention"] = port_base.AttentionKind(ref_cfg.attention.value)
    return port_base.ModelConfig(**kw)


def twin_params(ref_cfg, cfg, seed=0):
    ref_params, _ = rt.lm_init(ref_cfg, seed)
    return ref_params, pt.lm_init(cfg, seed, device="cpu")


def tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def prefill_inputs(cfg, seed, B, S):
    """(reference kwargs, port batch) of one prefill: ``tokens`` (B, S);
    for the audio family ``frontend`` frames (B, S, d) alone; for the VLM
    ``frontend`` patches (B, F, d) before the (B, S) text. Frontends are
    float32 normals, cast to the compute dtype inside."""
    fam = cfg.family.value
    kw = {}
    if fam != "audio":
        kw["tokens"] = tokens(seed, (B, S), cfg.vocab_size)
    if fam in ("audio", "vlm"):
        rows = S if fam == "audio" else cfg.frontend_tokens
        kw["frontend"] = np.random.default_rng(seed + 1).normal(
            0, 1, (B, rows, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in kw.items()},
            {k: torch.as_tensor(v) for k, v in kw.items()})


def assert_logits_close(ref_logits, port_logits, dtype):
    tol = LOGIT_TOL_F32 if dtype == "float32" else LOGIT_TOL_BF16
    exp = np.asarray(jnp.asarray(ref_logits, jnp.float32))
    got = port_logits.float().numpy()
    assert got.shape == exp.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, exp, atol=tol, rtol=0)


def check_init_and_convert(ref_params, params, dtype):
    """Leaves bit-identical in ``dtype``; convert.py carries them both ways
    exactly, keeping the dtype."""
    ref_leaves = jax.tree_util.tree_leaves(ref_params)
    leaves = tree_leaves(params)
    assert len(ref_leaves) == len(leaves)
    for a, b in zip(ref_leaves, leaves):
        assert b.dtype == dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      b.float().numpy())
    host = jax.device_get(ref_params)
    conv = convert.lm_params_from_reference(host, device="cpu")
    for a, b in zip(tree_leaves(conv), leaves):
        assert a.dtype == dtype and torch.equal(a, b)
    back = convert.lm_params_to_reference(params)
    for a, b in zip(jax.tree_util.tree_leaves(back), ref_leaves):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("arch", PORTED)
def test_lm_init_bit_identical(arch):
    ref_cfg, cfg = reduced_pair(arch)
    ref_params, params = twin_params(ref_cfg, cfg, seed=5)
    check_init_and_convert(ref_params, params, torch.float32)
    n = sum(t.numel() for t in tree_leaves(params))
    if cfg.family.value in ("dense", "moe", "audio", "vlm"):
        # the hybrid and SSM param_count formulas are estimates, in the
        # reference too (hymba's 160,320 for a tree of 148,296)
        assert n == cfg.param_count()


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "hymba-1.5b"])
def test_lm_init_bf16_params_bit_identical(arch):
    """param_dtype="bfloat16" (kimi-k2 stores its params so): numpy's f64
    draws rounded to bf16 as the reference rounds them, and kept bf16 by
    convert.py both ways."""
    ref_cfg, cfg = reduced_pair(arch, param_dtype="bfloat16")
    ref_params, params = twin_params(ref_cfg, cfg, seed=6)
    check_init_and_convert(ref_params, params, torch.bfloat16)


@pytest.mark.parametrize("arch", PORTED)
def test_param_shapes_match_reference(arch):
    """lm_param_shapes at full size: meta tensors, no draws, the
    reference's shapes and dtypes (its lm_init under abstract_init) leaf
    for leaf."""
    with ref_layers.abstract_init():
        ref_shapes = jax.tree_util.tree_leaves(
            rt.lm_init(ref_get_arch(arch), 0)[0])
    shapes = tree_leaves(pt.lm_param_shapes(port_config(ref_get_arch(arch))))
    assert all(t.device.type == "meta" for t in shapes)
    assert [tuple(s.shape) for s in ref_shapes] == [tuple(t.shape)
                                                    for t in shapes]
    assert [str(np.dtype(s.dtype)) for s in ref_shapes] == [
        str(t.dtype).replace("torch.", "") for t in shapes]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", PORTED)
def test_lm_apply_matches_reference(arch, dtype):
    ref_cfg, cfg = reduced_pair(arch, dtype=dtype)
    ref_params, params = twin_params(ref_cfg, cfg)
    ref_kw, batch = prefill_inputs(cfg, 1, 2, 24)
    exp = rt.lm_apply(ref_cfg, ref_params, **ref_kw)
    prefill = steps.make_prefill_step(cfg)
    got = prefill(pt.compute_params(cfg, params), batch)
    assert got.dtype == TDT[dtype]
    assert_logits_close(exp, got, dtype)
    # casting per call (f32 params) gives the same numbers as the copy
    torch.testing.assert_close(pt.lm_apply(cfg, params, **batch), got,
                               rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vlm_prefill_with_patch_prefix(dtype):
    """paligemma: F patch embeddings, then the text; logits over all F + S
    positions (the positions run on through the prefix), the patches cast
    to the compute dtype and scaled by sqrt(d_model) in it, as the
    reference does. Other patches change the text's logits."""
    ref_cfg, cfg = reduced_pair("paligemma-3b", dtype=dtype)
    ref_params, params = twin_params(ref_cfg, cfg)
    ref_kw, batch = prefill_inputs(cfg, 2, 3, 9)
    F = cfg.frontend_tokens
    got = pt.lm_apply(cfg, params, **batch)
    assert tuple(got.shape) == (3, F + 9, cfg.vocab_size)
    assert_logits_close(rt.lm_apply(ref_cfg, ref_params, **ref_kw), got,
                        dtype)
    other = dict(batch, frontend=batch["frontend"] * 2)
    text = pt.lm_apply(cfg, params, **other)[:, F:]
    assert not torch.equal(text, got[:, F:])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_audio_decode_step_on_a_frame(dtype):
    """musicgen's decode step on (B, d) frame embeddings (the reference's
    ``tokens.ndim == 2`` branch), from a cache filled by earlier frames:
    logits and caches against ``repro.models.transformer.lm_decode_step``,
    step by step."""
    ref_cfg, cfg = reduced_pair("musicgen-medium", dtype=dtype)
    ref_params, params = twin_params(ref_cfg, cfg)
    cparams = pt.compute_params(cfg, params)
    B, T = 3, 16
    ref_step = jax.jit(functools.partial(rt.lm_decode_step, ref_cfg))
    ref_state = rt.init_decode_state(ref_cfg, B, T)
    state = pt.init_decode_state(cfg, B, T, device="cpu")
    frames = np.random.default_rng(7).normal(
        0, 1, (5, B, cfg.d_model)).astype(np.float32)
    length = np.asarray([0, 4, 9], np.int32)
    for i in range(5):
        exp, ref_state = ref_step(ref_params, ref_state,
                                  jnp.asarray(frames[i]), jnp.asarray(length))
        got, state = pt.lm_decode_step(cfg, cparams, state,
                                       torch.as_tensor(frames[i]),
                                       torch.as_tensor(length))
        assert tuple(got.shape) == (B, cfg.vocab_size)
        assert_logits_close(exp, got, dtype)
        length = length + 1
    tol = STATE_TOL[dtype]
    for t in ("k", "v"):
        np.testing.assert_allclose(
            state["kv"][t].float().numpy(),
            np.asarray(ref_state["kv"][t].astype(jnp.float32)),
            atol=tol, rtol=tol)


def run_decode_twins(ref_cfg, cfg, batch, cache_len, lengths0, n_steps,
                     dtype):
    """Step both models from the same state; compare every step's logits
    and the final caches. Returns the port's final state."""
    ref_params, params = twin_params(ref_cfg, cfg)
    cparams = pt.compute_params(cfg, params)
    ref_step = jax.jit(functools.partial(rt.lm_decode_step, ref_cfg))
    ref_state = rt.init_decode_state(ref_cfg, batch, cache_len)
    state = pt.init_decode_state(cfg, batch, cache_len, device="cpu")
    length = np.asarray(lengths0, np.int32)
    toks = tokens(3, (n_steps, batch), cfg.vocab_size)
    for i in range(n_steps):
        exp, ref_state = ref_step(ref_params, ref_state, jnp.asarray(toks[i]),
                                  jnp.asarray(length))
        got, state = pt.lm_decode_step(cfg, cparams, state,
                                       torch.as_tensor(toks[i]),
                                       torch.as_tensor(length))
        assert_logits_close(exp, got, dtype)
        length = length + 1
    tol = STATE_TOL[dtype]
    if "kv" in state:
        for t in ("k", "v"):
            np.testing.assert_allclose(
                state["kv"][t].float().numpy(),
                np.asarray(ref_state["kv"][t].astype(jnp.float32)),
                atol=tol, rtol=tol)
    # recurrent states, held to STATE_TOL of each state's largest entry (in
    # bf16 the two frameworks' rounding differences add up step by step)
    rec = {k: v for k, v in state.items() if k != "kv"}
    ref_rec = {k: v for k, v in ref_state.items() if k != "kv"}
    ref_leaves = jax.tree_util.tree_leaves(ref_rec)
    leaves = tree_leaves(rec)
    assert len(ref_leaves) == len(leaves)
    for a, b in zip(ref_leaves, leaves):
        exp = np.asarray(a.astype(jnp.float32))
        assert exp.shape == tuple(b.shape)
        scale = tol * max(1.0, float(np.abs(exp).max()))
        np.testing.assert_allclose(b.float().numpy(), exp, atol=scale,
                                   rtol=0)
    return state


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", PORTED)
def test_decode_steps_match_reference(arch, dtype):
    ref_cfg, cfg = reduced_pair(arch, dtype=dtype)
    run_decode_twins(ref_cfg, cfg, batch=3, cache_len=16, lengths0=[0, 4, 9],
                     n_steps=5, dtype=dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_write_past_the_cache_is_dropped(dtype):
    """length >= T: JAX drops the out-of-bounds cache write and attends the
    full cache; the port does the same (no index error, rows unchanged)."""
    ref_cfg, cfg = reduced_pair("qwen3-1.7b", dtype=dtype)
    T = 6
    state = run_decode_twins(ref_cfg, cfg, batch=2, cache_len=T,
                             lengths0=[3, 5], n_steps=4, dtype=dtype)
    # slot 0 passed T after its 3rd step, slot 1 after its 1st: the rows
    # written before stay, nothing else was touched
    assert torch.count_nonzero(state["kv"]["k"][:, 0, :3]) == 0
    assert torch.count_nonzero(state["kv"]["k"][:, 0, 3:]) > 0
    assert torch.count_nonzero(state["kv"]["k"][:, 1, :5]) == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sliding_window_variant_matches_reference(dtype):
    """SLIDING attention: the window mask in prefill, the ring buffer of
    ``sliding_window`` rows in decode (written past the window)."""
    changes = dict(dtype=dtype, attention=AttentionKind.SLIDING,
                   sliding_window=5)
    ref_cfg, cfg = reduced_pair("qwen3-8b", **changes)
    ref_cfg = dataclasses.replace(ref_cfg, attention=rt.AttentionKind.SLIDING)
    ref_params, params = twin_params(ref_cfg, cfg)
    toks = tokens(4, (2, 20), cfg.vocab_size)
    assert_logits_close(rt.lm_apply(ref_cfg, ref_params,
                                    tokens=jnp.asarray(toks)),
                        pt.lm_apply(cfg, params, torch.as_tensor(toks)),
                        dtype)
    state = run_decode_twins(ref_cfg, cfg, batch=2, cache_len=64,
                             lengths0=[0, 3], n_steps=8, dtype=dtype)
    assert state["kv"]["k"].shape[2] == 5   # min(cache_len, window)


def reference_serve_loop(ref_cfg, ref_params, requests, slots, max_new,
                         cache_len):
    """The reference's launch/serve.py loop around its make_serve_step,
    recording the tokens each request emitted."""
    serve_step = jax.jit(ref_steps.make_serve_step(ref_cfg))
    state = rt.init_decode_state(ref_cfg, slots, cache_len)
    rng = np.random.default_rng(0)
    queue = [(int(rng.integers(0, ref_cfg.vocab_size)), max_new)
             for _ in range(requests)]
    slot_tok = jnp.zeros((slots,), jnp.int32)
    slot_left = np.zeros(slots, np.int64)
    slot_req = np.full(slots, -1)
    lengths = jnp.zeros((slots,), jnp.int32)
    out = [[] for _ in range(requests)]
    completed = steps_run = 0
    while completed < requests:
        for b in range(slots):
            if slot_left[b] == 0 and queue:
                slot_req[b] = len(queue) - 1
                tok, n = queue.pop()
                slot_tok = slot_tok.at[b].set(tok)
                slot_left[b] = n
                lengths = lengths.at[b].set(0)
        logits, state = serve_step(ref_params, state, slot_tok, lengths)
        next_tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        lengths = lengths + (slot_left > 0)
        slot_tok = jnp.where(jnp.asarray(slot_left > 0), next_tok, slot_tok)
        host = np.asarray(next_tok)
        steps_run += 1
        for b in range(slots):
            if slot_left[b] > 0:
                out[slot_req[b]].append(int(host[b]))
                slot_left[b] -= 1
                if slot_left[b] == 0:
                    completed += 1
    return out, steps_run


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "glm4-9b"] + list(OTHERS)
                         + list(FRONTEND))
def test_serve_loop_greedy_tokens_identical(arch):
    ref_cfg, cfg = reduced_pair(arch, dtype="float32")
    ref_params, params = twin_params(ref_cfg, cfg)
    exp, exp_steps = reference_serve_loop(ref_cfg, ref_params, requests=7,
                                          slots=3, max_new=6, cache_len=32)
    res = port_serve.serve(cfg, pt.compute_params(cfg, params), requests=7,
                           slots=3, max_new=6, cache_len=32, device="cpu")
    assert res.steps == exp_steps
    assert res.tokens == exp
    assert all(len(t) == 6 for t in res.tokens)


def test_serve_cli_on_cpu(capsys):
    res = port_serve.main(["--arch", "deepseek-67b", "--reduced",
                           "--requests", "5", "--slots", "2", "--max-new",
                           "4", "--cache-len", "16", "--device", "cpu"])
    assert len(res.tokens) == 5 and all(len(t) == 4 for t in res.tokens)
    assert res.steps == 12   # 3 waves of 4 steps on 2 slots
    assert "served 5 requests / 20 tokens" in capsys.readouterr().out


def test_serve_cli_exits_on_audio_as_the_reference(monkeypatch):
    """The reference's CLI exits on the audio family (its frames need
    examples/serve_batched.py) before it draws any params; so does the
    port's, with the same message. paligemma serves token prompts."""
    from repro.launch import serve as ref_serve

    monkeypatch.setattr("sys.argv", ["serve", "--arch", "musicgen-medium",
                                     "--reduced"])
    with pytest.raises(SystemExit) as ref_exit:
        ref_serve.main()
    monkeypatch.setattr(port_serve, "lm_init", None)   # never reached
    with pytest.raises(SystemExit) as port_exit:
        port_serve.main(["--arch", "musicgen-medium", "--reduced",
                         "--device", "cpu"])
    assert str(port_exit.value) == str(ref_exit.value)
    assert "serve_batched" in str(port_exit.value)
    monkeypatch.undo()
    res = port_serve.main(["--arch", "paligemma-3b", "--reduced",
                           "--requests", "3", "--slots", "2", "--max-new",
                           "3", "--cache-len", "8", "--device", "cpu"])
    assert [len(t) for t in res.tokens] == [3, 3, 3]


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_param_count_matches_reference(arch):
    ref_cfg = ref_get_arch(arch)
    cfg = port_config(ref_cfg)
    assert cfg.head_dim == ref_cfg.head_dim
    assert cfg.param_count() == ref_cfg.param_count()


@pytest.mark.parametrize("arch", FRONTEND)
def test_frontend_archs_resolve_at_full_width(arch):
    """The audio and VLM ids resolve in the port as in the reference, field
    for field; their full-width trees (meta tensors, nothing drawn) hold
    ``param_count`` parameters."""
    cfg = port_config_pkg.get_arch(arch)
    assert cfg == port_config(ref_get_arch(arch))
    assert cfg.family in pt.FAMILIES
    shapes = tree_leaves(pt.lm_param_shapes(cfg))
    assert all(t.device.type == "meta" for t in shapes)
    assert sum(t.numel() for t in shapes) == cfg.param_count()
    if cfg.tie_embeddings:
        assert pt.lm_param_shapes(cfg)["head"] == {}


def test_assigned_archs_and_registry_match_reference():
    import repro.config as ref_config

    assert port_configs.ASSIGNED_ARCHS == ASSIGNED_ARCHS
    # the port's own Trinity-Mini ids beside every id of the reference
    assert port_config_pkg.list_archs() == sorted(
        ref_config.list_archs() + ["trinity-mini", "trinity-mini-ep8-8l"])
    assert set(ASSIGNED_ARCHS) == set(PORTED)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_subquadratic_matches_reference(arch):
    ref_cfg = ref_get_arch(arch)
    cfg = port_config_pkg.get_arch(arch)
    assert cfg.subquadratic == ref_cfg.subquadratic
    assert cfg.is_recurrent == ref_cfg.is_recurrent


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_shape_applicable_matches_reference(arch, shape):
    """Only the sub-quadratic archs (sliding window, recurrent) take
    long_500k's 524,288-row context."""
    got = port_config_pkg.shape_applicable(port_config_pkg.get_arch(arch),
                                           port_config_pkg.SHAPES[shape])
    assert got == ref_applicable(ref_get_arch(arch), REF_SHAPES[shape])
    if shape == "long_500k":
        assert got == (arch in ("hymba-1.5b", "xlstm-350m"))
    else:
        assert got


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", PORTED)
def test_input_specs_match_reference(arch, shape):
    """Every (arch, shape) cell ``shape_applicable`` admits."""
    if not ref_applicable(ref_get_arch(arch), REF_SHAPES[shape]):
        assert not port_config_pkg.shape_applicable(
            port_config(ref_get_arch(arch)), SHAPES[shape])
        return
    ref_specs = ref_steps.input_specs(ref_get_arch(arch), REF_SHAPES[shape])
    specs = steps.input_specs(port_config(ref_get_arch(arch)), SHAPES[shape])
    ref_flat = jax.tree_util.tree_leaves(ref_specs)
    flat = []

    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, tuple) and not isinstance(t, steps.Spec):
            for x in t:
                walk(x)
        else:
            flat.append(t)

    walk(specs)
    assert [tuple(s.shape) for s in ref_flat] == [s[0] for s in flat]
    assert [str(np.dtype(s.dtype)) for s in ref_flat] == [
        str(d).replace("torch.", "") for _, d in flat]
