"""The port's dry run (``repro_torch/launch/dryrun.py``) and roofline
(``repro_torch/launch/roofline.py``) on the CPU, each world a ``fake``
process group inside a subprocess.

- The reduced qwen3-1.7b train step (AdamW, 2 microbatches) runs on meta
  DTensors over 8 ranks at (2, 4): the counterpart of the reference's
  8-device compile test (``tests/test_sharding.py``). Its params and
  optimizer state come back at the placements they went in with.
- Full-width ``lower_cell`` records: qwen3-8b x train_4k x single,
  dbrx-132b x prefill_32k x single (its MoE on the expert-parallel mesh
  path), xlstm-350m x decode_32k x multi, qwen3-8b x decode_32k x single
  (decode attention on each shard's cache), and a skipped long_500k
  cell.
  ``params``, ``active_params``, ``tokens``, ``mode`` and the skip reason
  equal the reference's (``repro/launch/dryrun.py``); the remat'd train
  cell's ``useful_flops_ratio`` lies in [0.6, 1.0]; argument bytes per
  device equal the sum over the reference's resolved specs
  (``repro.launch.sharding.resolve_spec``).
- Per-device FLOPs of one sharded matmul are ``FlopCounterMode``'s global
  count over the chips; for a matmul of inputs whole on every rank,
  ``flops_with_replicas`` is the whole count.
- ``roofline_terms`` on a fixed record equals the formula at the H100's
  peaks.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.config import SHAPES as REF_SHAPES  # noqa: E402
from repro.config import get_arch as ref_get_arch  # noqa: E402
from repro.launch import sharding as rs  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models import transformer as rt  # noqa: E402
from repro.models.layers import abstract_init  # noqa: E402
from repro.optim import make_optimizer as ref_make_optimizer  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CELLS = [("qwen3-8b", "train_4k", False), ("dbrx-132b", "prefill_32k", False),
         ("xlstm-350m", "decode_32k", True), ("qwen3-8b", "decode_32k", False),
         ("qwen3-8b", "long_500k", False)]
CELL_SPLIT = 1             # the train cell in one process, the rest in another

CELL_SCRIPT = r"""
import json, sys
from repro_torch.launch.dryrun import lower_cell
out = {}
for arch, shape, multi in json.loads(sys.argv[1]):
    out["%s|%s|%s" % (arch, shape, "multi" if multi else "single")] = \
        lower_cell(arch, shape, multi)
print("RECORDS " + json.dumps(out))
"""

STEP_SCRIPT = r"""
import json
import torch
from torch.distributed.tensor import DTensor
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.config.base import (MeshConfig, OptimizerConfig,
                                     ShapeConfig, TrainConfig)
from repro_torch.configs.qwen3_1p7b import reduced
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import SINGLE_POD, make_mesh
from repro_torch.launch.sharding import distribute
from repro_torch.launch.steps import make_train_step
from repro_torch.tree import tree_leaves

res = {}
cfg = reduced()
shape = ShapeConfig("t", seq_len=32, global_batch=8, mode="train")
tc = TrainConfig(optimizer=OptimizerConfig(name="adamw"), microbatches=2)
with dryrun.fake_world(8):
    mesh = make_mesh(MeshConfig((2, 4), ("data", "model")), "cpu")
    params, opt_state, batch = dryrun.step_arguments(cfg, shape, mesh, tc)
    step, _ = make_train_step(cfg, tc)
    with dryrun.step_cost(mesh, 8) as cost:
        new_p, new_st, metrics = step(params, opt_state, batch)
        # out_shardings: the new state laid out as the old
        new_p = dryrun.laid_out_as(new_p, params)
        new_st = dryrun.laid_out_as(new_st, opt_state)
    def layout(tree):
        return [[tuple(t.shape), [str(p) for p in t.placements]]
                for t in tree_leaves(tree)]
    res["step"] = dict(
        params_in=layout(params), params_out=layout(new_p),
        opt_in=layout(opt_state), opt_out=layout(new_st),
        loss_is_dtensor=isinstance(metrics["loss"], DTensor),
        loss_shape=list(metrics["loss"].shape), flops=cost["flops"],
        coll=cost["coll"])
with dryrun.fake_world(256):
    mesh = make_mesh(SINGLE_POD, "cpu")
    x = distribute(mesh, torch.empty((32, 512, 2048), dtype=torch.bfloat16,
                                     device="meta"), ("batch", None, None))
    w = distribute(mesh, torch.empty((2048, 6144), dtype=torch.bfloat16,
                                     device="meta"), ("embed", "mlp"))
    with dryrun.step_cost(mesh, 256) as cost:
        x @ w
    with FlopCounterMode(display=False) as fc:
        x @ w
    res["matmul"] = dict(per_device=cost["flops"],
                         with_replicas=cost["flops_with_replicas"],
                         flop_counter=fc.get_total_flops(),
                         collectives=cost["collectives"])
    # inputs whole on every rank: each rank runs the whole matmul
    xr = distribute(mesh, torch.empty((32, 512, 2048), dtype=torch.bfloat16,
                                      device="meta"), (None, None, None))
    wr = distribute(mesh, torch.empty((2048, 1024), dtype=torch.bfloat16,
                                      device="meta"), (None, None))
    with dryrun.step_cost(mesh, 256) as cost:
        y = xr @ wr
    res["replicated"] = dict(per_device=cost["flops"],
                             with_replicas=cost["flops_with_replicas"],
                             placements=[str(p) for p in y.placements])
print("STEP " + json.dumps(res))
"""


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
                OMP_NUM_THREADS="1")


@pytest.fixture(scope="module")
def runs():
    """Three subprocesses at once: the train cell, the other cells, and
    the step and the matmul."""
    def start(*args):
        return subprocess.Popen([sys.executable, "-c", *args],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True,
                                env=_env(), cwd=str(ROOT))

    procs = [("RECORDS ", start(CELL_SCRIPT, json.dumps(CELLS[:CELL_SPLIT]))),
             ("RECORDS ", start(CELL_SCRIPT, json.dumps(CELLS[CELL_SPLIT:]))),
             ("STEP ", start(STEP_SCRIPT))]
    out = {"cells": {}}
    for tag, p in procs:
        so, se = p.communicate(timeout=600)
        line = next((ln for ln in so.splitlines() if ln.startswith(tag)),
                    None)
        assert p.returncode == 0 and line, se[-4000:]
        got = json.loads(line[len(tag):])
        if tag == "STEP ":
            out["step"] = got
        else:
            out["cells"].update(got)
    return out


@pytest.fixture(scope="module")
def ref_dryrun():
    """The reference's dry-run module; its import appends a 512-device
    XLA flag to the environment, which later subprocesses must not see."""
    saved = os.environ.get("XLA_FLAGS")
    import repro.launch.dryrun as rd
    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved
    return rd


def test_train_step_on_eight_ranks(runs):
    step = runs["step"]["step"]
    assert step["params_out"] == step["params_in"]
    assert step["opt_out"] == step["opt_in"]
    assert step["loss_is_dtensor"] and step["loss_shape"] == []
    assert step["flops"] > 0 and step["coll"] > 0


def test_sharded_matmul_flops_are_the_global_count_over_chips(runs):
    mm = runs["step"]["matmul"]
    total = 2 * 32 * 512 * 2048 * 6144
    assert mm["flop_counter"] == total
    assert math.isclose(mm["per_device"] * 256, total, rel_tol=1e-12)
    assert mm["with_replicas"] == mm["per_device"]
    # the weight's "embed" shards are gathered over "data"
    assert mm["collectives"]["counts"]["all-gather"] >= 1


def test_replicated_matmul_flops_are_counted_on_every_rank(runs):
    """A matmul of inputs whole on every rank: ``flops`` spreads it over
    the 256 chips, ``flops_with_replicas`` counts it whole, since each
    rank runs all of it."""
    rep = runs["step"]["replicated"]
    assert rep["placements"] == ["R", "R"]
    total = 2 * 32 * 512 * 2048 * 1024
    assert math.isclose(rep["per_device"] * 256, total, rel_tol=1e-12)
    assert rep["with_replicas"] == total


def _ref_tree_bytes(shapes, axes, mesh):
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    total = 0

    def walk(s, a):
        nonlocal total
        if s is None:
            return
        if hasattr(s, "shape"):
            ax = a if a is not None else (None,) * len(s.shape)
            spec = rs.resolve_spec(s.shape, ax, mesh)
            split = 1
            for entry in spec:
                for name in (entry if isinstance(entry, tuple)
                             else (entry,) if entry else ()):
                    split *= sizes[name]
            total += int(np.prod(s.shape)) // split * s.dtype.itemsize
        elif isinstance(s, dict):
            for k in s:
                walk(s[k], a[k])
        elif hasattr(s, "_fields"):
            for i, f in enumerate(s._fields):
                walk(getattr(s, f), a[f] if isinstance(a, dict) else a[i])
        else:
            for i, t in enumerate(s):
                walk(t, a[i])
    walk(shapes, axes)
    return total


class FakeMesh:
    def __init__(self, shape, axes):
        self.axis_names = axes
        self.devices = np.zeros(shape)


def _ref_argument_bytes(rd, arch, shape_name, multi):
    cfg, shape = ref_get_arch(arch), REF_SHAPES[shape_name]
    mesh = (FakeMesh((2, 16, 16), ("pod", "data", "model")) if multi
            else FakeMesh((16, 16), ("data", "model")))
    with abstract_init():
        ps, pa = rt.lm_init(cfg, 0)
    total = _ref_tree_bytes(ps, pa, mesh)
    specs = ref_steps.input_specs(cfg, shape)
    total += _ref_tree_bytes(specs, ref_steps.batch_axes(cfg, shape), mesh)
    if shape.mode == "train":
        tc = rd._train_cfg(cfg, shape)
        init, _ = ref_make_optimizer(tc.optimizer)
        total += _ref_tree_bytes(jax.eval_shape(init, ps),
                                 ref_steps.opt_state_axes(cfg, pa,
                                                          tc.optimizer),
                                 mesh)
    return total, ps


@pytest.mark.parametrize("cell", CELLS[:-1],
                         ids=lambda c: f"{c[0]}-{c[1]}")
def test_records_match_reference(runs, ref_dryrun, cell):
    arch, shape_name, multi = cell
    rec = runs["cells"][f"{arch}|{shape_name}|{'multi' if multi else 'single'}"]
    assert rec["status"] == "ok", rec.get("traceback")
    arg_bytes, ps = _ref_argument_bytes(ref_dryrun, arch, shape_name, multi)
    cfg, shape = ref_get_arch(arch), REF_SHAPES[shape_name]
    assert rec["params"] == ref_dryrun._actual_params(ps)
    assert rec["active_params"] == ref_dryrun._actual_active_params(cfg, ps)
    assert rec["tokens"] == (shape.tokens if shape.mode != "decode"
                             else shape.global_batch)
    assert rec["mode"] == shape.mode
    assert rec["num_devices"] == (512 if multi else 256)
    assert rec["memory"]["argument_size_in_bytes"] == arg_bytes
    assert rec["flops_total"] > 0 and rec["bytes_total"] > 0
    assert rec["collective_bytes"]["total"] > 0
    assert rec["roofline"] == roofline.roofline_terms(rec)
    if shape.mode == "train":
        assert cfg.remat
        assert 0.6 <= rec["roofline"]["useful_flops_ratio"] <= 1.0
        # some of the step's matmuls run whole on each rank of an axis
        assert rec["flops_with_replicas"] > rec["flops_total"]
        assert rec["microbatches"] == ref_dryrun._train_cfg(cfg, shape
                                                            ).microbatches


def test_skipped_cell_matches_reference(runs, ref_dryrun):
    rec = runs["cells"]["qwen3-8b|long_500k|single"]
    ref = ref_dryrun.lower_cell("qwen3-8b", "long_500k", False)
    assert rec == ref and rec["status"] == "skipped"


def test_roofline_terms_at_h100_peaks():
    rec = {"num_devices": 256, "flops_total": 2.0e15, "bytes_total": 4.0e12,
           "collective_bytes": {"total": 1.0e11}, "active_params": 8e9,
           "tokens": 1_048_576, "mode": "train"}
    t = roofline.roofline_terms(rec)
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (
        989e12, 3.35e12, 50e9)
    assert t["compute_s"] == 2.0e15 / 989e12
    assert t["memory_s"] == 4.0e12 / 3.35e12
    assert t["collective_s"] == 1.0e11 / 50e9
    model = 6.0 * 8e9 * 1_048_576
    assert t["model_flops"] == model
    assert t["useful_flops_ratio"] == model / 256 / 2.0e15
    assert t["dominant"] == "compute"
    assert t["roofline_fraction"] == (model / 256 / 989e12) / t["compute_s"]
    assert roofline.LINK_BW == roofline.IB_BW
