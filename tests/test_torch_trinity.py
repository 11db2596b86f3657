"""Trinity-Mini (Arcee's AFMoE) on the port's LM path, against the plain
reference that the benchmark holds it to (``portbench/reference/
lm_afmoe.py``), on the CPU at the reduced size: 2 dense and 4 MoE layers
(layer 3 full, the rest windowed), 8 of 16 experts held, top-4, a window
of 8 under sequences of 20.

Both sides compute in float32 and sum the same products in another order:
the worst leaf's gradient read 8.4e-7 of its norm and the loss 1e-7 of
itself, so gradients are held to 1e-5 of each leaf's norm, logits to 1e-5
of the largest and the loss to 1e-6. The grouped matmul's backward (the
CPU runs its plain version through the same autograd function as the
card's kernel) is held to the plain einsum's autograd within 1e-5, the
forward's float32 tolerance being 1e-4.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.reference import lm_afmoe as ref  # noqa: E402
from repro_torch.config.base import AttentionKind  # noqa: E402
from repro_torch.config.registry import get_arch  # noqa: E402
from repro_torch.configs import trinity_mini  # noqa: E402
from repro_torch.kernels import moe_gmm as gmm  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.layers import mlp_apply  # noqa: E402
from repro_torch.monitoring import trace  # noqa: E402
from repro_torch.tree import tree_leaves, tree_unflatten  # noqa: E402

GRAD_RTOL = 1e-5
LOGIT_TOL = 1e-5
LOSS_RTOL = 1e-6
GMM_GRAD_TOL = 1e-5
B, S = 3, 20
MOE_SPANS = ("moe_route", "moe_experts", "moe_combine")
MOE_COUNTERS = ("moe_rows_routed", "moe_rows_launched", "moe_max_load",
                "moe_load_reads")


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def f32(**changes):
    return dataclasses.replace(trinity_mini.reduced(), dtype="float32",
                               **changes)


def model_block(cfg) -> dict:
    return json.loads(json.dumps(dataclasses.asdict(cfg)))


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def draw(cfg, seed: int):
    """(the program's params, the reference's flat params): one normal
    draw a leaf at the reference's standard deviation, ones for norms."""
    g = torch.Generator().manual_seed(seed)
    layout = tfm.lm_param_shapes(cfg)
    leaves = {}
    for path, t in flat(layout).items():
        std = ref.init_std(path, tuple(t.shape))
        leaves[path] = torch.ones(t.shape) if std is None else \
            torch.randn(t.shape, generator=g) * std
    params = tree_unflatten(layout, [leaves[k].clone() for k in
                                     flat(layout)])
    return params, leaves


def tokens(cfg, seed: int, batch=B, seq=S):
    g = torch.Generator().manual_seed(seed + 1000)
    return torch.randint(0, cfg.vocab_size, (batch, seq), generator=g,
                         dtype=torch.int32)


@pytest.mark.parametrize("arch", ["trinity-mini", "trinity-mini-ep8-8l",
                                  "reduced"])
def test_param_layout_matches_reference(arch):
    cfg = trinity_mini.reduced() if arch == "reduced" else get_arch(arch)
    shapes = {k: tuple(t.shape) for k, t in
              flat(tfm.lm_param_shapes(cfg)).items()}
    assert shapes == ref.param_shapes(model_block(cfg))
    assert sum(int(np.prod(s)) for s in shapes.values()) == cfg.param_count()
    axes = flat(tfm.lm_param_axes(cfg))
    assert set(axes) == set(shapes)
    assert all(len(axes[k]) == len(v) for k, v in shapes.items())


def test_published_and_cut_configs():
    full, cut = get_arch("trinity-mini"), get_arch("trinity-mini-ep8-8l")
    assert round(full.param_count() / 1e9, 1) == 26.1
    assert round(cut.param_count() / 1e9, 2) == 1.04
    assert [cut.layer_is_full(i) for i in range(8)] == [False] * 3 + [
        True] + [False] * 3 + [True]
    assert (cut.num_experts, cut.experts_here, cut.vocab_size) == (
        128, 16, 25024)
    assert dataclasses.replace(cut, name=full.name, num_layers=32,
                               experts_held=0, vocab_size=200192) == full
    assert not full.subquadratic
    assert all(get_arch("qwen3-1.7b").layer_is_full(i) for i in range(3))
    assert not any(get_arch("hymba-1.5b").layer_is_full(i)
                   for i in range(8))
    assert full.attention == AttentionKind.SLIDING


def test_benchmark_configuration_is_the_cut():
    """The benchmark's configuration file states the program's cut field
    for field, and the reference's step FLOPs at its cell's shape."""
    c = json.loads((ROOT / "portbench" / "configs" /
                    "trinity-mini.json").read_text())
    cfg = get_arch(c["arch"])
    assert c["model"] == model_block(cfg)
    assert (c["num_hidden_layers"], c["num_experts"], c["vocab_size"]) == (
        cfg.num_layers, cfg.experts_here, cfg.vocab_size)
    assert c["layer_types"] == ["full_attention" if cfg.layer_is_full(i)
                                else "sliding_attention" for i in range(8)]
    flops = ref.step_flops(c["model"], 8, 4096)
    assert 1.0e14 < flops < 1.1e14
    assert ref.expert_flops(c["model"], 8, 4096) < flops / 10


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_loss_logits_and_gradients_match_reference(seed, remat):
    cfg = f32(remat=remat)
    model = model_block(cfg)
    params, leaves = draw(cfg, seed)
    toks = tokens(cfg, seed)
    loss, grads = steps._grads(cfg, params, {"tokens": toks,
                                             "labels": toks})
    rl, rg = ref.loss_and_grads(model, leaves, toks)
    assert float(loss) == pytest.approx(rl, rel=LOSS_RTOL)
    got = flat(tree_unflatten(params, grads))
    for k, exp in rg.items():
        gap = float((got[k] - exp).norm() / exp.norm())
        assert gap < GRAD_RTOL, (k, gap)
    with torch.no_grad():
        lg = tfm.lm_apply(cfg, params, tokens=toks)
    exp = ref.logits(model, leaves, toks)
    np.testing.assert_allclose(lg.numpy(), exp.numpy(),
                               atol=LOGIT_TOL * float(exp.abs().max()))


def _uncut_layer(cfg, leaves, x):
    """The reference's whole MoE layer (every expert held): shared expert
    plus routed sum, on (T, d) rows."""
    model = model_block(dataclasses.replace(cfg, experts_held=0))
    p = {k[len("blocks/"):]: v[0] for k, v in leaves.items()
         if k.startswith("blocks/")}
    shared = ref._swiglu(x, p["moe/shared/w_gate"], p["moe/shared/w_up"],
                         p["moe/shared/w_down"], "float32")
    return shared + ref._experts(model, p, x, "float32"), p


@pytest.mark.parametrize("shares", [2, 4, 8])
def test_expert_shares_add_up_to_the_uncut_layer(shares):
    """Each chip's share (experts [j n, (j + 1) n) held, routed over all
    16), summed with the shared expert counted once, gives the uncut
    reference layer."""
    cfg = f32(experts_held=0)
    _, leaves = draw(cfg, 7)
    x = torch.randn((B, S, cfg.d_model), generator=torch.Generator(
    ).manual_seed(8))
    exp, p = _uncut_layer(cfg, leaves, x.reshape(B * S, -1))
    n = cfg.num_experts // shares
    total = mlp_apply(cfg, {k[len("moe/shared/"):]: v for k, v in p.items()
                            if k.startswith("moe/shared/")}, x)
    for j in range(shares):
        pj = {"router": p["moe/router"],
              **{w: p[f"moe/{w}"][j * n:(j + 1) * n]
                 for w in moe.EXPERT_WEIGHTS}}
        total = total + moe._moe_local(cfg, pj, x, j * n, n)
    np.testing.assert_allclose(total.reshape(B * S, -1).numpy(),
                               exp.numpy(), atol=1e-5, rtol=1e-5)


def test_a_router_skewed_onto_one_expert_drops_no_pick():
    """Every token picks expert 0: its load is every token, past the
    capacity factor's buckets. The dropless layer reads the load once and
    runs every pick, as the reference does; the capacity path drops."""
    cfg = f32(experts_held=0)
    _, leaves = draw(cfg, 3)
    x = torch.randn((B, S, cfg.d_model), generator=torch.Generator(
    ).manual_seed(4))
    x[..., 0] = 1.0
    leaves["blocks/moe/router"][:, 0, 0] = 60.0
    exp, p = _uncut_layer(cfg, leaves, x.reshape(B * S, -1))
    pm = {"router": p["moe/router"],
          **{w: p[f"moe/{w}"] for w in moe.EXPERT_WEIGHTS}}
    shared = mlp_apply(cfg, {k[len("moe/shared/"):]: v for k, v in p.items()
                             if k.startswith("moe/shared/")}, x)
    T = B * S
    assert moe.capacity(cfg, T) < T
    reads = moe.load_reads
    trace.clear()
    trace.enable()
    try:
        got = shared + moe.moe_apply(cfg, pm, x, layer=2)
    finally:
        trace.disable()
    events = trace.get_tracer().events()
    trace.clear()
    assert moe.load_reads == reads + 1
    top = [e["args"]["moe_max_load"] for e in events
           if e["name"] == "moe_max_load"]
    assert top == [T]
    np.testing.assert_allclose(got.reshape(T, -1).numpy(), exp.numpy(),
                               atol=1e-5, rtol=1e-5)
    capped = shared + moe.moe_apply(
        dataclasses.replace(cfg, moe_dropless=False), pm, x)
    assert not torch.allclose(capped, got, atol=1e-3)


@pytest.mark.parametrize("on", [True, False])
def test_moe_spans_and_counters_only_when_traced(on):
    cfg = f32()
    params, _ = draw(cfg, 5)
    toks = tokens(cfg, 5)
    trace.clear()
    if on:
        trace.enable()
    try:
        with torch.no_grad():
            tfm.lm_apply(cfg, params, tokens=toks)
    finally:
        trace.disable()
    events = trace.get_tracer().events()
    trace.clear()
    if not on:
        assert events == []
        return
    n_moe = cfg.num_layers - cfg.moe_dense_first_n
    moe_layers = list(range(cfg.moe_dense_first_n, cfg.num_layers))
    for name in MOE_SPANS:
        spans = [e for e in events if e["name"] == name]
        assert [e["args"]["layer"] for e in spans] == moe_layers
        assert all(e["ph"] == "X" for e in spans)
    counts = {n: [e["args"][n] for e in events if e["name"] == n]
              for n in MOE_COUNTERS}
    assert all(len(v) == n_moe for v in counts.values())
    picks = B * S * cfg.experts_per_token
    assert all(0 < r <= picks for r in counts["moe_rows_routed"])
    assert all(launched % gmm.GROUP_ROWS == 0 and launched >= routed
               for launched, routed in zip(counts["moe_rows_launched"],
                                           counts["moe_rows_routed"]))
    assert counts["moe_load_reads"] == sorted(counts["moe_load_reads"])


GMM_CASES = [(4, 96, 192, 320), (2, 128, 256, 256), (8, 64, 128, 512),
             (1, 256, 512, 128), (3, 100, 130, 70)]


@pytest.mark.parametrize("E,C,din,dout", GMM_CASES)
def test_moe_gmm_backward_matches_plain_autograd(E, C, din, dout):
    g = torch.Generator().manual_seed(E * C)
    xg = torch.randn((E, C, din), generator=g).requires_grad_()
    wg = (torch.randn((E, din, dout), generator=g) / din ** 0.5
          ).requires_grad_()
    cot = torch.randn((E, C, dout), generator=g)
    gmm.moe_gmm(xg, wg).backward(cot)
    plain = [t.detach().clone().requires_grad_() for t in (xg, wg)]
    gmm.moe_gmm_ref(*plain).backward(cot)
    for got, exp in zip((xg.grad, wg.grad), plain):
        np.testing.assert_allclose(got.numpy(), exp.grad.numpy(),
                                   atol=GMM_GRAD_TOL, rtol=GMM_GRAD_TOL)


def test_train_step_trains_the_reduced_model():
    """Three AdamW steps of the reduced model in its compute dtype
    (bfloat16): finite losses, every leaf reached by the gradient."""
    cfg = trinity_mini.reduced()
    step, opt_init = steps.make_train_step(cfg, steps.TrainConfig())
    params = tfm.lm_init(cfg, seed=0, device="cpu")
    state = opt_init(params)
    toks = tokens(cfg, 0)
    for _ in range(3):
        before = [t.clone() for t in tree_leaves(params)]
        params, state, m = step(params, state, {"tokens": toks,
                                                "labels": toks})
        assert np.isfinite(float(m["loss"]))
    assert all(not torch.equal(a, b) for a, b in
               zip(before, tree_leaves(params)))


def test_train_cli_trains_trinity(tmp_path, capsys):
    from repro_torch.launch import train as port_train

    out = port_train.main(["--arch", "trinity-mini", "--reduced", "--steps",
                           "2", "--batch", "2", "--seq", "16", "--device",
                           "cpu", "--ckpt-dir", str(tmp_path)])
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))


def test_serving_a_mixed_model_is_refused():
    with pytest.raises(NotImplementedError, match="windowed and full"):
        tfm.init_decode_state(trinity_mini.reduced(), 2, 16, device="cpu")


def test_the_reference_imports_no_program_and_no_jax():
    code = ("import sys; sys.path[:0] = [%r]\n"
            "import importlib.util as u\n"
            "s = u.spec_from_file_location('r', %r)\n"
            "m = u.module_from_spec(s); s.loader.exec_module(m)\n"
            "bad = [n for n in sys.modules if n.split('.')[0] in\n"
            "       ('jax', 'jaxlib', 'flax', 'repro', 'repro_torch')]\n"
            "print(bad)\n" % (str(ROOT), str(Path(ref.__file__))))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_an_expert_that_no_token_picks_gets_a_zero_gradient():
    """Two tokens make 8 picks over 16 experts: held experts that no
    token picks run nothing and get zero gradients, in the program and in
    the reference alike (whose per-layer gradient allows unused leaves)."""
    cfg = f32()
    model = model_block(cfg)
    params, leaves = draw(cfg, 9)
    toks = tokens(cfg, 9, batch=1, seq=2)
    _, grads = steps._grads(cfg, params, {"tokens": toks, "labels": toks})
    # two tokens are no deployment's load: no band on the held picks
    _, rg = ref.loss_and_grads(model, leaves, toks, band=None)
    got = flat(tree_unflatten(params, grads))
    w = rg["blocks/moe/w_up"]
    idle = (w.flatten(2).abs().amax(-1) == 0)
    assert idle.any()
    assert torch.equal(idle, got["blocks/moe/w_up"].flatten(2).abs()
                       .amax(-1) == 0)
    for k, exp in rg.items():   # a leaf with no gradient (k_norm) too
        assert float((got[k] - exp).norm()) <= GRAD_RTOL * max(
            float(exp.norm()), 1e-12), k


def _routed(cfg, params, toks) -> int:
    """The program's held picks over the MoE layers (its
    ``moe_rows_routed`` counters)."""
    trace.clear()
    trace.enable()
    try:
        with torch.no_grad():
            tfm.lm_apply(cfg, params, tokens=toks)
    finally:
        trace.disable()
    events = trace.get_tracer().events()
    trace.clear()
    return sum(e["args"]["moe_rows_routed"] for e in events
               if e["name"] == "moe_rows_routed")


def test_reference_refuses_held_picks_outside_the_band():
    """The reference counts the held picks as the program's
    ``moe_rows_routed`` does, accepts its batch's share inside the band and
    raises ``RoutingDrift`` outside it: a zeroed router ties every score,
    the lower ids win, and every pick falls on the held experts (E / held =
    2 times their expectation)."""
    cfg = f32()
    model = model_block(cfg)
    params, leaves = draw(cfg, 4)
    toks = tokens(cfg, 4)
    n_moe = cfg.num_layers - cfg.moe_dense_first_n
    with pytest.raises(ref.RoutingDrift) as err:
        ref.loss_and_grads(model, leaves, toks, band=(10.0, 11.0))
    assert err.value.picks == _routed(cfg, params, toks)
    share = err.value.share
    assert ref.HELD_BAND[0] <= share <= ref.HELD_BAND[1]
    assert share == ref.held_share(model, err.value.picks, toks.numel())
    ref.loss_and_grads(model, leaves, toks)           # inside the band

    leaves["blocks/moe/router"].zero_()
    params["blocks"]["moe"]["router"].zero_()
    T, k = toks.numel(), cfg.experts_per_token
    with pytest.raises(ref.RoutingDrift, match="held experts took") as err:
        ref.loss_and_grads(model, leaves, toks)
    assert err.value.picks == n_moe * T * k == _routed(cfg, params, toks)
    assert err.value.share == cfg.num_experts / cfg.experts_here
    ref.loss_and_grads(model, leaves, toks, band=None)


def segments(loads, rows=128):
    """(offsets, tile_expert) of experts with ``loads`` rows each, every
    segment rounded up to ``rows``."""
    tiles = [-(-n // rows) for n in loads]
    offsets = torch.tensor([0] + list(np.cumsum(tiles) * rows),
                           dtype=torch.int32)
    tile_expert = torch.repeat_interleave(torch.arange(len(loads)),
                                          torch.tensor(tiles)).int()
    return offsets, tile_expert


@pytest.mark.parametrize("loads", [(130, 0, 5, 256), (1, 1), (300,)])
def test_moe_gmm_grouped_matches_plain_autograd(loads):
    """The grouped form (segments of 128-row multiples, an empty expert
    among them) and its backward against the plain per-segment product's
    autograd; padding rows stay zero."""
    g = torch.Generator().manual_seed(sum(loads))
    offsets, tile_expert = segments(loads)
    R, din, dout = int(offsets[-1]), 48, 40
    x = torch.zeros((R, din))
    o = offsets.tolist()
    for e, n in enumerate(loads):
        x[o[e]:o[e] + n] = torch.randn((n, din), generator=g)
    x.requires_grad_()
    wg = (torch.randn((len(loads), din, dout), generator=g) / din ** 0.5
          ).requires_grad_()
    cot = torch.randn((R, dout), generator=g)
    got = gmm.moe_gmm_grouped(x, wg, offsets, tile_expert)
    got.backward(cot)
    plain = [t.detach().clone().requires_grad_() for t in (x, wg)]
    exp = torch.cat([plain[0][o[e]:o[e + 1]] @ plain[1][e]
                     for e in range(len(loads))])
    exp.backward(cot)
    np.testing.assert_allclose(got.detach().numpy(), exp.detach().numpy(),
                               atol=GMM_GRAD_TOL, rtol=GMM_GRAD_TOL)
    for a, b in zip((x.grad, wg.grad), plain):
        np.testing.assert_allclose(a.numpy(), b.grad.numpy(),
                                   atol=GMM_GRAD_TOL, rtol=GMM_GRAD_TOL)
    for e, n in enumerate(loads):
        assert (float(wg.grad[e].abs().max()) == 0) == (n == 0)
