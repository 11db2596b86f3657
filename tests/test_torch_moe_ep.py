"""The port's expert-parallel MoE path (``repro_torch/models/moe.py``)
against the reference's ``shard_map`` path (``repro/models/moe.py``) on
the CPU, at dbrx-132b's and kimi-k2's ``reduced()`` configs (E = 4 and 8)
in float32.

- The reference runs ``moe_apply`` (jitted) under ``jax.make_mesh`` on 8
  virtual CPU devices in a subprocess (the XLA flag must precede JAX's
  import), at (1, 4) and (2, 4) ("data", "model"), and with no mesh.
- The port's ``emulate`` executor at the same layouts (``use_mesh`` with a
  ``MeshConfig``) is held to it within EP_TOL = 1e-5 (the partials are
  summed over the model shards in another order), and at (1, 4) also to
  the no-mesh path (the same capacity). At (2, 4) each data shard routes
  its own tokens with its own capacity: ``emulate`` equals the local path
  run on each shard's rows alone.
- The port's ``mesh`` executor in a gloo world of 4 spawned processes, at
  (1, 4) and (2, 2), params and input laid out as DTensors by the
  logical-axis rules (experts over "model", the contraction dims ZeRO-stored
  over "data" and gathered), equals ``emulate`` at the same layout within
  EP_TOL, and so do the gradients of a fixed linear loss of its output
  with respect to the router, the three expert weights and the input:
  the gathered weights' gradients come back reduce-scattered over "data",
  the partial sums over the batch and model shards are summed.
"""

import dataclasses
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.config import MeshConfig  # noqa: E402
from repro_torch.configs import dbrx_132b, kimi_k2_1t_a32b  # noqa: E402
from repro_torch.launch.sharding import use_mesh  # noqa: E402
from repro_torch.models import moe  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
EP_TOL = 1e-5
CONFIGS = {"dbrx": dbrx_132b, "kimi": kimi_k2_1t_a32b}
REF_LAYOUTS = ((1, 4), (2, 4))
MESH_LAYOUTS = ((1, 4), (2, 2))
PARAM_SEED, X_SEED, G_SEED = 11, 12, 13
GRAD_LEAVES = ("router", "w_gate", "w_up", "w_down")
X_SHAPE = (4, 16)          # (B, S): the batch splits over 2 data shards

REF_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses
import jax, jax.numpy as jnp
import numpy as np
from repro.configs.dbrx_132b import reduced as dbrx
from repro.configs.kimi_k2_1t_a32b import reduced as kimi
from repro.models import moe

out = {}
for name, make in (("dbrx", dbrx), ("kimi", kimi)):
    cfg = dataclasses.replace(make(), dtype="float32", param_dtype="float32")
    p, _ = moe.moe_init(cfg, np.random.default_rng(%(pseed)d))
    x = np.random.default_rng(%(xseed)d).normal(
        0, 1, %(xshape)s + (cfg.d_model,)).astype(np.float32)
    apply = jax.jit(lambda p, x: moe.moe_apply(cfg, p, x))
    out[name + "-none"] = np.asarray(apply(p, jnp.asarray(x)))
    for shape in %(layouts)s:
        mesh = jax.make_mesh(shape, ("data", "model"))
        with mesh:
            y = jax.jit(lambda p, x: moe.moe_apply(cfg, p, x))(
                p, jnp.asarray(x))
        out["%%s-%%dx%%d" %% ((name,) + shape)] = np.asarray(y)
np.savez(sys.argv[1], **out)
print("REF_OK")
"""

MESH_SCRIPT = r"""
import dataclasses, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import dbrx_132b, kimi_k2_1t_a32b
from repro_torch.launch.sharding import distribute, distribute_tree, use_mesh
from repro_torch.models import moe

rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="tcp://localhost:" + port,
                        rank=rank, world_size=4)
res = {}
for name, mod in (("dbrx", dbrx_132b), ("kimi", kimi_k2_1t_a32b)):
    cfg = dataclasses.replace(mod.reduced(), dtype="float32",
                              param_dtype="float32")
    p = moe.moe_init(cfg, np.random.default_rng(%(pseed)d))
    x = torch.as_tensor(np.random.default_rng(%(xseed)d).normal(
        0, 1, %(xshape)s + (cfg.d_model,)), dtype=torch.float32)
    g = torch.as_tensor(np.random.default_rng(%(gseed)d).normal(
        0, 1, %(xshape)s + (cfg.d_model,)), dtype=torch.float32)
    for shape in %(layouts)s:
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
        pd = distribute_tree(mesh, p, moe.moe_axes())
        xd = distribute(mesh, x, ("batch", None, None))
        for t in list(pd.values()) + [xd]:
            t.requires_grad_()
        with use_mesh(mesh):
            y = moe.moe_apply(cfg, pd, xd)
        assert tuple(y.placements) == tuple(xd.placements)
        full = y.full_tensor()
        key = "%%s-%%dx%%d" %% ((name,) + shape)
        res[key] = full.detach().numpy()
        (full * g).sum().backward()
        for n, t in list(pd.items()) + [("x", xd)]:
            res[key + "-grad-" + n] = t.grad.full_tensor().numpy()
dist.barrier()
dist.destroy_process_group()
if rank == 0:
    np.savez(out, **res)
print("MESH_OK", rank)
"""


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")


def _fmt(script, layouts):
    return script % dict(pseed=PARAM_SEED, xseed=X_SEED, gseed=G_SEED,
                         xshape=repr(X_SHAPE), layouts=repr(layouts))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("moe_ep") / "ref.npz"
    run = subprocess.run([sys.executable, "-c", _fmt(REF_SCRIPT, REF_LAYOUTS),
                          str(path)], capture_output=True, text=True,
                         env=_env(), cwd=str(ROOT), timeout=300)
    assert "REF_OK" in run.stdout, run.stderr[-3000:]
    return dict(np.load(path))


def _case(name):
    cfg = dataclasses.replace(CONFIGS[name].reduced(), dtype="float32",
                              param_dtype="float32")
    p = moe.moe_init(cfg, np.random.default_rng(PARAM_SEED))
    x = torch.as_tensor(np.random.default_rng(X_SEED).normal(
        0, 1, X_SHAPE + (cfg.d_model,)), dtype=torch.float32)
    return cfg, p, x


def _emulate(cfg, p, x, layout):
    with use_mesh(MeshConfig(layout, ("data", "model"))):
        return moe.moe_apply(cfg, p, x)


def _close(got, exp):
    np.testing.assert_allclose(np.asarray(got, np.float32), exp,
                               atol=EP_TOL, rtol=EP_TOL)


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("layout", REF_LAYOUTS, ids=["1x4", "2x4"])
def test_emulate_matches_reference_mesh_path(reference, name, layout):
    cfg, p, x = _case(name)
    E_local = cfg.num_experts // layout[1]
    calls = []
    orig = moe.ops.moe_gmm

    def counted(xg, wg, impl=None):
        calls.append(tuple(xg.shape))
        return orig(xg, wg, impl)

    moe.ops.moe_gmm = counted
    try:
        with torch.no_grad():
            got = _emulate(cfg, p, x, layout)
    finally:
        moe.ops.moe_gmm = orig
    # three grouped matmuls a block, each on the block's E_local experts
    # with the capacity of its own batch shard
    T_local = X_SHAPE[0] // layout[0] * X_SHAPE[1]
    assert len(calls) == 3 * layout[0] * layout[1]
    assert {c[:2] for c in calls} == {(E_local,
                                       moe.capacity(cfg, T_local))}
    _close(got, reference[f"{name}-{layout[0]}x{layout[1]}"])
    with torch.no_grad():
        plain = moe.moe_apply(cfg, p, x)
    _close(plain, reference[f"{name}-none"])
    if layout[0] == 1:  # one data shard: the no-mesh capacity and routing
        _close(got, plain.numpy())


@pytest.mark.parametrize("name", list(CONFIGS))
def test_emulate_two_data_shards_is_the_local_path_per_shard(name):
    cfg, p, x = _case(name)
    with torch.no_grad():
        got = _emulate(cfg, p, x, (2, 4))
        per_shard = torch.cat([moe.moe_apply(cfg, p, xi)
                               for xi in torch.split(x, 2, 0)], 0)
    _close(got, per_shard.numpy())


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return str(s.getsockname()[1])


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """The mesh executor's outputs and gradients from a gloo world of 4."""
    out = tmp_path_factory.mktemp("moe_ep_mesh") / "mesh.npz"
    port = _free_port()
    script = _fmt(MESH_SCRIPT, MESH_LAYOUTS)
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r), port,
                               str(out)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=_env(),
                              cwd=str(ROOT)) for r in range(4)]
    logs = [p.communicate(timeout=300) for p in procs]
    for r, (p, (so, se)) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"MESH_OK {r}" in so, se[-3000:]
    return dict(np.load(out))


def test_mesh_executor_in_a_gloo_world_matches_emulate(mesh_run):
    for name in CONFIGS:
        cfg, p, x = _case(name)
        for layout in MESH_LAYOUTS:
            with torch.no_grad():
                exp = _emulate(cfg, p, x, layout)
            _close(mesh_run[f"{name}-{layout[0]}x{layout[1]}"], exp.numpy())


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("layout", MESH_LAYOUTS, ids=["1x4", "2x2"])
def test_mesh_executor_gradients_match_emulate(mesh_run, name, layout):
    cfg, p, x = _case(name)
    g = torch.as_tensor(np.random.default_rng(G_SEED).normal(
        0, 1, X_SHAPE + (cfg.d_model,)), dtype=torch.float32)
    p = {n: t.clone().requires_grad_() for n, t in p.items()}
    x = x.clone().requires_grad_()
    (_emulate(cfg, p, x, layout) * g).sum().backward()
    key = f"{name}-{layout[0]}x{layout[1]}-grad-"
    for n in GRAD_LEAVES:
        assert float(p[n].grad.abs().max()) > 0, n
        _close(mesh_run[key + n], p[n].grad.numpy())
    _close(mesh_run[key + "x"], x.grad.numpy())
