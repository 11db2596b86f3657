"""The port's logical-axis sharding (``repro_torch/launch/sharding.py``)
against the reference's (``repro/launch/sharding.py``) on the CPU.

- The rule cases of ``tests/test_sharding.py`` in both packages.
- ``resolve_spec`` equal to the reference's ``PartitionSpec`` entry for
  entry, on the single-pod (16, 16) and multi-pod (2, 16, 16) meshes, for
  every leaf of: the params of every assigned arch, the batch of every
  applicable (arch, train/prefill shape), the decode state of every
  applicable (arch, decode shape), and the optimizer state of ``adamw``,
  ``adafactor``, ``sgd`` and ``momentum``. The reference side takes its
  duck-typed ``FakeMesh`` and ``abstract_init``; the port's takes a
  ``MeshConfig`` and ``meta`` tensors.
- ``lm_param_axes``, ``kv_cache_axes``, ``decode_state_axes``,
  ``batch_axes`` and ``opt_state_axes`` equal the reference's trees.
- ``shard`` is a no-op on plain tensors: a reduced forward is bit for bit
  the same with the constraints in place, with them removed, and under an
  installed layout.
"""

import dataclasses

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

torch = pytest.importorskip("torch")

from repro.config import SHAPES as REF_SHAPES  # noqa: E402
from repro.config import get_arch as ref_get_arch  # noqa: E402
from repro.config import shape_applicable as ref_applicable  # noqa: E402
from repro.config.base import OptimizerConfig as RefOptimizerConfig  # noqa: E402
from repro.configs import ASSIGNED_ARCHS  # noqa: E402
from repro.launch import sharding as rs  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models import attention as ref_attention  # noqa: E402
from repro.models import transformer as rt  # noqa: E402
from repro.models.layers import abstract_init  # noqa: E402
from repro.optim import make_optimizer as ref_make_optimizer  # noqa: E402
from repro_torch.config import SHAPES, MeshConfig, OptimizerConfig, get_arch  # noqa: E402
from repro_torch.launch import sharding as ps  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import MULTI_POD, SINGLE_POD  # noqa: E402
from repro_torch.models import attention as pa  # noqa: E402
from repro_torch.models import transformer as pt  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402


class FakeMesh:
    """The reference tests' duck-typed mesh (axis names and shape)."""

    def __init__(self, shape, axes):
        self.axis_names = axes
        self.devices = np.zeros(shape)


REF_MESHES = {"single": FakeMesh((16, 16), ("data", "model")),
              "multi": FakeMesh((2, 16, 16), ("pod", "data", "model"))}
PORT_MESHES = {"single": SINGLE_POD, "multi": MULTI_POD}
OPTIMIZERS = ("adamw", "adafactor", "sgd", "momentum")

# tests/test_sharding.py:26-63: (shape, logical axes, mesh, overrides,
# expected spec)
RULE_CASES = {
    "divisible_dims_shard": ((2048, 6144), ("embed", "mlp"), "single", {},
                             P("data", "model")),
    "25_heads_replicated": ((4, 25, 64), ("batch", "heads", None), "single",
                            {}, P(None, None, None)),
    "vocab_32001_replicated": ((32001, 1600), ("vocab", "embed"), "single",
                               {}, P(None, "data")),
    "axis_used_once": ((16, 6144, 10752), ("experts", "embed", "mlp"),
                       "single", {}, P("model", "data", None)),
    "batch_over_pod_and_data": ((256, 4096), ("batch", "seq"), "multi", {},
                                P(("pod", "data"), None)),
    "batch_prefix_fallback": ((2, 4096), ("batch", "seq"), "multi", {},
                              P("pod", None)),
    "rules_override": ((2048, 6144), ("embed", "mlp"), "single",
                       {"mlp": ()}, P("data", None)),
}


@pytest.mark.parametrize("case", list(RULE_CASES))
def test_rule_cases_both_packages(case):
    shape, axes, mesh, overrides, want = RULE_CASES[case]
    with rs.axis_rules(**overrides):
        ref = rs.resolve_spec(shape, axes, REF_MESHES[mesh])
    with ps.axis_rules(**overrides):
        port = ps.resolve_spec(shape, axes, PORT_MESHES[mesh])
        # the reference's FakeMesh resolves in the port too
        duck = ps.resolve_spec(shape, axes, REF_MESHES[mesh])
        assert ps.current_rules()["mlp"] == overrides.get("mlp", ("model",))
    assert ps.current_rules() is ps.DEFAULT_RULES   # the context restored
    assert ref == want
    assert port == duck == tuple(want)


def _pairs(shapes, axes):
    """(shape, axes) of every leaf, walking the (dict / tuple) shape tree;
    ``None`` subtrees are empty."""
    if shapes is None:
        return []
    if hasattr(shapes, "shape"):   # a ShapeDtypeStruct, a tensor, a Spec
        ax = axes if axes is not None else (None,) * len(shapes.shape)
        return [(tuple(shapes.shape), ax)]
    if isinstance(shapes, dict):
        return [p for k in sorted(shapes) for p in _pairs(shapes[k],
                                                          axes[k])]
    if hasattr(shapes, "_fields"):
        return [p for i, f in enumerate(shapes._fields)
                for p in _pairs(getattr(shapes, f), axes[f]
                                if isinstance(axes, dict) else axes[i])]
    if isinstance(shapes, (list, tuple)):
        return [p for i, s in enumerate(shapes) for p in _pairs(s, axes[i])]
    raise TypeError(f"not a tree of shapes: {shapes!r}")


def _same_specs(ref_shapes, ref_axes, port_shapes, port_axes):
    ref, port = _pairs(ref_shapes, ref_axes), _pairs(port_shapes, port_axes)
    assert [s for s, _ in ref] == [s for s, _ in port]
    assert [a for _, a in ref] == [a for _, a in port]
    for mesh in REF_MESHES:
        for (shape, ax), _ in zip(ref, port):
            want = rs.resolve_spec(shape, ax, REF_MESHES[mesh])
            got = ps.resolve_spec(shape, ax, PORT_MESHES[mesh])
            assert got == tuple(want), (mesh, shape, ax, got, want)
    return len(ref)


def _ref_params(arch):
    with abstract_init():
        return rt.lm_init(ref_get_arch(arch), 0)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_param_specs_match_reference(arch):
    shapes, axes = _ref_params(arch)
    cfg = get_arch(arch)
    n = _same_specs(shapes, axes, pt.lm_param_shapes(cfg),
                    pt.lm_param_axes(cfg))
    assert n >= 8


BATCH_CELLS = [(a, s) for a in ASSIGNED_ARCHS for s in ("train_4k",
                                                         "prefill_32k")
               if ref_applicable(ref_get_arch(a), REF_SHAPES[s])]
DECODE_CELLS = [(a, s) for a in ASSIGNED_ARCHS
                for s in ("decode_32k", "long_500k")
                if ref_applicable(ref_get_arch(a), REF_SHAPES[s])]


@pytest.mark.parametrize("arch,shape", BATCH_CELLS)
def test_batch_specs_match_reference(arch, shape):
    rcfg, cfg = ref_get_arch(arch), get_arch(arch)
    _same_specs(ref_steps.input_specs(rcfg, REF_SHAPES[shape]),
                ref_steps.batch_axes(rcfg, REF_SHAPES[shape]),
                steps.input_specs(cfg, SHAPES[shape]),
                steps.batch_axes(cfg, SHAPES[shape]))


@pytest.mark.parametrize("arch,shape", DECODE_CELLS)
def test_decode_state_specs_match_reference(arch, shape):
    rcfg, cfg = ref_get_arch(arch), get_arch(arch)
    ref = ref_steps.input_specs(rcfg, REF_SHAPES[shape])
    port = steps.input_specs(cfg, SHAPES[shape])
    rax = ref_steps.batch_axes(rcfg, REF_SHAPES[shape])
    pax = steps.batch_axes(cfg, SHAPES[shape])
    assert _same_specs(ref, rax, port, pax) >= 4


@pytest.mark.parametrize("opt", OPTIMIZERS)
def test_opt_state_specs_match_reference(opt):
    for arch in ASSIGNED_ARCHS:
        shapes, axes = _ref_params(arch)
        ref_init, _ = ref_make_optimizer(RefOptimizerConfig(name=opt))
        ref_state = jax.eval_shape(ref_init, shapes)
        cfg = get_arch(arch)
        init, _ = make_optimizer(OptimizerConfig(name=opt))
        port_state = init(pt.lm_param_shapes(cfg))
        rax = ref_steps.opt_state_axes(ref_get_arch(arch), axes,
                                       RefOptimizerConfig(name=opt))
        pax = steps.opt_state_axes(cfg, pt.lm_param_axes(cfg),
                                   OptimizerConfig(name=opt))
        assert pax == rax
        _same_specs(ref_state, rax, port_state, pax)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_axes_trees_equal_reference(arch):
    rcfg, cfg = ref_get_arch(arch), get_arch(arch)
    _, axes = _ref_params(arch)
    assert pt.lm_param_axes(cfg) == axes
    assert pt.decode_state_axes(cfg) == rt.decode_state_axes(rcfg)
    assert pa.kv_cache_axes(cfg) == ref_attention.kv_cache_axes(rcfg)
    for name in SHAPES:
        assert steps.batch_axes(cfg, SHAPES[name]) == ref_steps.batch_axes(
            rcfg, REF_SHAPES[name])
    for opt in OPTIMIZERS:
        assert steps.opt_state_axes(cfg, axes, OptimizerConfig(name=opt)) \
            == ref_steps.opt_state_axes(rcfg, axes,
                                        RefOptimizerConfig(name=opt))


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "hymba-1.5b", "xlstm-350m",
                                  "paligemma-3b"])
def test_shard_is_a_no_op_without_a_mesh(arch, monkeypatch):
    """The forward with every ``shard`` site, with the sites removed (the
    model before them), and under an installed layout (plain tensors
    stay plain) are bit for bit one."""
    import importlib

    mod = importlib.import_module(
        f"repro_torch.configs.{arch.replace('-', '_').replace('.', 'p')}")
    cfg = dataclasses.replace(mod.reduced(), dtype="float32")
    params = pt.lm_init(cfg, 0, device="cpu")
    rng = np.random.default_rng(7)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 12)))
    frontend = None
    if cfg.family.value == "vlm":
        frontend = torch.as_tensor(rng.normal(
            0, 1, (2, cfg.frontend_tokens, cfg.d_model)), dtype=torch.float32)
    with torch.no_grad():
        base = pt.lm_apply(cfg, params, tokens=tokens, frontend=frontend)
        layout = MeshConfig((2, 4), ("data", "model"))
        with ps.use_mesh(layout):
            assert ps.active_mesh() is layout
            meshed = pt.lm_apply(cfg, params, tokens=tokens,
                                 frontend=frontend)
        assert ps.active_mesh() is None
        for m in ("repro_torch.models.layers", "repro_torch.models.attention",
                  "repro_torch.models.ssm", "repro_torch.models.transformer"):
            monkeypatch.setattr(f"{m}.shard", lambda x, *a: x)
        bare = pt.lm_apply(cfg, params, tokens=tokens, frontend=frontend)
    assert torch.equal(base, bare)
    assert torch.equal(base, meshed)


def test_placements_and_named_sharding():
    from torch.distributed.tensor import Replicate, Shard

    spec = ps.resolve_spec((256, 4096), ("batch", "seq"), MULTI_POD)
    assert ps.placements(spec, MULTI_POD) == (Shard(0), Shard(0),
                                              Replicate())
    ns = ps.named_sharding(SINGLE_POD, (16, 6144, 10752),
                           ("experts", "embed", "mlp"))
    assert ns.spec == ("model", "data", None)
    assert ns.placements == (Shard(1), Shard(0))
    tree = {"w": torch.empty((2048, 6144), device="meta"), "n": None}
    got = ps.tree_shardings(SINGLE_POD, tree, {"w": ("embed", "mlp"),
                                               "n": None})
    assert got["w"].spec == ("data", "model") and got["n"] is None


def test_mesh_builders_need_a_process_group():
    """``make_mesh`` and ``make_production_mesh`` raise without a running
    world instead of starting one; the meshes keep the reference's shapes
    and axis names."""
    import torch.distributed as dist

    from repro_torch.launch import mesh

    assert not dist.is_initialized()
    assert (mesh.SINGLE_POD.shape, mesh.SINGLE_POD.axes) == ((16, 16),
                                                             ("data", "model"))
    assert (mesh.MULTI_POD.shape, mesh.MULTI_POD.axes) == (
        (2, 16, 16), ("pod", "data", "model"))
    assert mesh.MULTI_POD.num_devices == 512
    with pytest.raises(RuntimeError, match="process group"):
        mesh.make_mesh(MeshConfig((2, 2), ("data", "model")), "cpu")
    with pytest.raises(RuntimeError, match="process group"):
        mesh.make_production_mesh(multi_pod=True, device_type="cpu")
    assert not dist.is_initialized()
