"""The port's LM train path against the reference's on the CPU, at the
``reduced()`` sizes of qwen3-1.7b (dense), dbrx-132b (MoE), hymba-1.5b
(hybrid) and xlstm-350m (SSM): ``cross_entropy``, ``lm_loss``,
``lm_apply(drop_last_logit=True)``, ``synth_batch`` and ``make_train_step``
(``repro/launch/steps.py``, ``repro/models/transformer.py``), the
reference run with its plain kernels (``impl="ref"``, its default).

Params come from ``lm_init`` at one seed (bit-identical draws), batches
from ``synth_batch`` (bit-identical draws). Tolerances:
- ``cross_entropy`` and ``lm_loss`` in float32: LOSS_TOL = 1e-5 relative
  (the same math; logsumexp and the matmuls sum in another order).
- ``make_train_step``, 3 steps, float32 (``dataclasses.replace(cfg,
  dtype="float32")``): loss and grad norm within STEP_RTOL = 1e-4
  relative, params and optimizer state within STEP_RTOL (1 + |x|). Every
  optimizer runs at ``OptimizerConfig``'s default lr of 3e-4: AdamW's
  first update is about lr times the gradient's sign, so a gradient entry
  near 0 whose last bits differ moves by up to lr (measured 1.3e-4 at lr
  1e-2 on hymba, 1.3e-2 of lr).
- One bfloat16 step at the reference kernel tests' bf16 tolerance,
  BF16_RTOL = 2e-2 (the frameworks round products and fused chains at
  other places).
"""

import dataclasses
import importlib

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.config.base import OptimizerConfig as RefOptimizerConfig  # noqa: E402
from repro.config.base import ShapeConfig as RefShapeConfig  # noqa: E402
from repro.config.base import TrainConfig as RefTrainConfig  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models import transformer as rt  # noqa: E402
from repro_torch.config.base import (OptimizerConfig, ShapeConfig,  # noqa: E402
                                     TrainConfig)
from repro_torch.kernels import NoKernelGradError  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402
from repro_torch.models import transformer as pt  # noqa: E402
from repro_torch.tree import tree_leaves, tree_unflatten  # noqa: E402

ARCHS = ("qwen3-1.7b", "dbrx-132b", "hymba-1.5b", "xlstm-350m")
OPTIMIZERS = ("sgd", "momentum", "adamw", "adafactor")
#: (microbatches, remat): a Latin square over ARCHS x OPTIMIZERS, so every
#: arch and every optimizer meets each pair once.
MB_REMAT = ((1, False), (2, True), (1, True), (2, False))
STEP_CASES = [(arch, opt) + MB_REMAT[(i + j) % 4]
              for i, arch in enumerate(ARCHS)
              for j, opt in enumerate(OPTIMIZERS)]
LOSS_TOL = 1e-5
STEP_RTOL = 1e-4
BF16_RTOL = 2e-2
BATCH, SEQ = 4, 16


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs several test files at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def reduced_pair(arch, **changes):
    """(reference config, port config) of ``arch``'s reduced size."""
    name = port_serve.REDUCED_MODULES[arch].split(".")[-1]
    ref_mod = importlib.import_module("repro.configs." + name)
    port_mod = importlib.import_module(port_serve.REDUCED_MODULES[arch])
    return (dataclasses.replace(ref_mod.reduced(), **changes),
            dataclasses.replace(port_mod.reduced(), **changes))


def shapes(seq=SEQ, batch=BATCH, mode="train"):
    return (RefShapeConfig("t", seq, batch, mode),
            ShapeConfig("t", seq, batch, mode))


def twin_batch(rc, pc, seed, **kw):
    rs, ps = shapes(**kw)
    rb = ref_steps.synth_batch(rc, rs, seed=seed)
    pb = steps.synth_batch(pc, ps, seed=seed, device="cpu")
    return rb, pb


def assert_tree_close(ref_tree, port_tree, rtol):
    ref_leaves = jax.tree_util.tree_leaves(ref_tree)
    leaves = tree_leaves(port_tree)
    assert len(ref_leaves) == len(leaves)
    for a, b in zip(ref_leaves, leaves):
        a = np.asarray(a, np.float64)
        b = b.double().numpy()
        assert a.shape == b.shape
        assert np.all(np.abs(a - b) <= rtol * (1 + np.abs(a)))


@pytest.mark.parametrize("arch", ARCHS)
def test_synth_batch_bit_exact(arch):
    rc, pc = reduced_pair(arch)
    for mode in ("train", "prefill"):
        rb, pb = twin_batch(rc, pc, seed=7, mode=mode)
        assert sorted(rb) == sorted(pb)
        for k in rb:
            assert pb[k].dtype == torch.int32
            np.testing.assert_array_equal(np.asarray(rb[k]), pb[k].numpy())


@pytest.mark.parametrize("shape", [(2, 5, 11), (3, 300)])
def test_cross_entropy_matches_reference(shape):
    rng = np.random.default_rng(3)
    logits = rng.normal(0, 4, shape + (97,)).astype(np.float32)
    targets = rng.integers(0, 97, shape).astype(np.int32)
    exp = np.asarray(rt.cross_entropy(logits, targets))
    got = pt.cross_entropy(torch.from_numpy(logits),
                           torch.from_numpy(targets)).numpy()
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_allclose(got, exp, rtol=LOSS_TOL, atol=0)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_matches_reference(arch, masked):
    rc, pc = reduced_pair(arch, dtype="float32")
    ref_params, _ = rt.lm_init(rc, 0)
    params = pt.lm_init(pc, 0, device="cpu")
    rb, pb = twin_batch(rc, pc, seed=11)
    if masked:
        mask = np.random.default_rng(5).random((BATCH, SEQ)) < 0.6
        rb = dict(rb, loss_mask=mask)
        pb = dict(pb, loss_mask=torch.from_numpy(mask))
    exp = float(rt.lm_loss(rc, ref_params, rb))
    with torch.no_grad():
        got = pt.lm_loss(pc, params, pb)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(float(got) - exp) <= LOSS_TOL * abs(exp)


@pytest.mark.parametrize("arch", ARCHS)
def test_drop_last_logit_slices_before_unembed(arch):
    rc, pc = reduced_pair(arch, dtype="float32")
    ref_params, _ = rt.lm_init(rc, 0)
    params = pt.lm_init(pc, 0, device="cpu")
    rb, pb = twin_batch(rc, pc, seed=12)
    exp = np.asarray(rt.lm_apply(rc, ref_params, tokens=rb["tokens"],
                                 drop_last_logit=True))
    with torch.no_grad():
        full = pt.lm_apply(pc, params, pb["tokens"])
        got = pt.lm_apply(pc, params, pb["tokens"], drop_last_logit=True)
    assert tuple(got.shape) == (BATCH, SEQ - 1, pc.vocab_size)
    torch.testing.assert_close(got, full[:, :-1], rtol=0, atol=0)
    np.testing.assert_allclose(got.numpy(), exp, rtol=0, atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_changes_no_number(arch):
    """Checkpointed blocks run the same ops again: loss and gradients equal
    bit for bit with and without remat."""
    outs = []
    for remat in (False, True):
        _, pc = reduced_pair(arch, dtype="float32", remat=remat)
        params = pt.lm_init(pc, 0, device="cpu")
        pb = steps.synth_batch(pc, shapes()[1], seed=13, device="cpu")
        outs.append(steps._grads(pc, params, pb))
    (l0, g0), (l1, g1) = outs
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def run_both(arch, opt, microbatches, remat, dtype="float32", n_steps=3):
    """``n_steps`` of the reference's jitted step and the port's on the
    same params and batches; yields each step's (ref, port) triples."""
    rc, pc = reduced_pair(arch, dtype=dtype, remat=remat)
    ref_step, ref_init = ref_steps.make_train_step(rc, RefTrainConfig(
        optimizer=RefOptimizerConfig(name=opt), microbatches=microbatches))
    step, init = steps.make_train_step(pc, TrainConfig(
        optimizer=OptimizerConfig(name=opt), microbatches=microbatches))
    ref_step = jax.jit(ref_step)
    rp, _ = rt.lm_init(rc, 0)
    pp = pt.lm_init(pc, 0, device="cpu")
    ro, po = ref_init(rp), init(pp)
    for s in range(n_steps):
        rb, pb = twin_batch(rc, pc, seed=100 + s)
        rp, ro, rm = ref_step(rp, ro, rb)
        pp, po, pm = step(pp, po, pb)
        yield (rp, ro, rm), (pp, po, pm)


@pytest.mark.parametrize("arch,opt,microbatches,remat", STEP_CASES)
def test_train_step_matches_reference(arch, opt, microbatches, remat):
    for (rp, ro, rm), (pp, po, pm) in run_both(arch, opt, microbatches,
                                               remat):
        for key in ("loss", "grad_norm"):
            exp, got = float(rm[key]), float(pm[key])
            assert np.isfinite(got)
            assert abs(got - exp) <= STEP_RTOL * abs(exp), key
        assert po.step.dtype == torch.int32
        assert int(po.step) == int(ro.step)
        assert_tree_close(rp, pp, STEP_RTOL)
        assert_tree_close(ro.inner, po.inner, STEP_RTOL)
        for a, b in zip(jax.tree_util.tree_leaves(rp), tree_leaves(pp)):
            assert str(b.dtype) == "torch." + str(a.dtype)
            assert not b.requires_grad


def test_train_step_bf16_matches_reference():
    losses = []
    for (rp, ro, rm), (pp, po, pm) in run_both("qwen3-1.7b", "adamw", 2,
                                               True, dtype="bfloat16"):
        for key in ("loss", "grad_norm"):
            exp, got = float(rm[key]), float(pm[key])
            assert abs(got - exp) <= BF16_RTOL * abs(exp), key
        assert_tree_close(rp, pp, BF16_RTOL)
        losses.append(float(pm["loss"]))
    assert all(np.isfinite(losses))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_specs_match_reference(arch):
    rc, pc = reduced_pair(arch)
    rs, ps = shapes(seq=64, batch=8)
    ref_specs = ref_steps.input_specs(rc, rs)
    specs = steps.input_specs(pc, ps)
    assert sorted(ref_specs) == sorted(specs) == ["labels", "tokens"]
    for k, s in ref_specs.items():
        assert specs[k] == steps.Spec(tuple(s.shape), torch.int32)


def test_train_cli_on_cpu(tmp_path, capsys):
    out = port_train.main(["--arch", "qwen3-1.7b", "--reduced", "--steps",
                           "12", "--batch", "2", "--seq", "32",
                           "--save-every", "5", "--ckpt-dir",
                           str(tmp_path / "ck"), "--device", "cpu"])
    assert out["restarts"] == 0 and len(out["losses"]) == 12
    assert all(np.isfinite(out["losses"]))
    assert out["losses"][-1] < out["losses"][0]
    assert "done: 12 steps" in capsys.readouterr().out
    # a second run finds step 12 committed and takes no step
    again = port_train.main(["--arch", "qwen3-1.7b", "--reduced", "--steps",
                             "12", "--ckpt-dir", str(tmp_path / "ck"),
                             "--device", "cpu"])
    assert again["losses"] == []


@pytest.mark.parametrize("arch", ["musicgen-medium", "paligemma-3b"])
def test_train_cli_other_families_raise_10c(arch, tmp_path):
    with pytest.raises(NotImplementedError, match="module 10.c"):
        port_train.main(["--arch", arch, "--reduced", "--ckpt-dir",
                         str(tmp_path), "--device", "cpu"])


def test_train_cli_defaults_to_the_card():
    args = port_train.build_parser().parse_args(["--arch", "qwen3-1.7b"])
    assert args.device == "cuda"
    assert (args.steps, args.batch, args.seq, args.lr, args.save_every) == (
        100, 8, 128, 3e-4, 25)


@pytest.mark.parametrize("arch", ["dbrx-132b", "hymba-1.5b", "xlstm-350m"])
def test_train_cli_refuses_kernel_gradients_on_the_card(arch, tmp_path):
    """On the card the MoE, hybrid and SSM families would train through
    kernels with no backward pass: the CLI raises before its first step
    (no card is touched, so this runs on the CPU too)."""
    with pytest.raises(NoKernelGradError, match='impl="ref"'):
        port_train.main(["--arch", arch, "--reduced", "--ckpt-dir",
                         str(tmp_path), "--device", "cuda"])


def test_remat_recompute_keeps_the_callers_kernel_impl():
    """The backward pass may run on another thread than the forward (on the
    card, autograd's own); the thread-local default impl there is not the
    caller's. A checkpointed block recomputes under the impl its forward
    ran with, or the recompute saves other tensors and autograd raises."""
    import threading

    from repro_torch.kernels import ops

    _, pc = reduced_pair("qwen3-1.7b", dtype="float32", remat=True)
    params = pt.lm_init(pc, 0, device="cpu")
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    pb = steps.synth_batch(pc, shapes()[1], seed=14, device="cpu")
    with ops.default_impl("ref"):
        with torch.enable_grad():
            loss = pt.lm_loss(pc, tree_unflatten(params, leaves), pb)
    assert ops.get_default_impl() == "cuda"
    out = {}

    def backward():  # a fresh thread: its default impl is "cuda"
        out["grads"] = torch.autograd.grad(loss, leaves, allow_unused=True)

    worker = threading.Thread(target=backward)
    worker.start()
    worker.join()
    assert "grads" in out
    _, exp = steps._grads(dataclasses.replace(pc, remat=False), params, pb)
    for a, b in zip(out["grads"], exp):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
