"""Dry run: cost every (arch x shape x mesh) cell on a fake world of 256 or
512 ranks (``repro/launch/dryrun.py``), with nothing allocated and
nothing sent.

    python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all [--mesh single|multi|both] [--out f.json]

Each cell starts a ``fake`` process group of the mesh's size
(``torch.testing``'s ``FakeStore``; a collective returns at once) inside
this process only, builds the production mesh on it, lays out params,
optimizer state and batch as ``meta`` DTensors at the placements the
logical-axis rules resolve (``launch/sharding.py``), and runs the model
code on them under ``use_mesh``, every kernel on its plain version (the
plain versions run on ``meta``; the kernels need the card). The world is
torn down when the cell ends. Results accumulate in a JSON file, so a run
resumes.

Costs follow the reference's ``component_cost_analysis``: one block's
forward, its gradient (and, under remat, its forward again), the embed and
head (their gradient for train), each at a microbatch's batch, and the
optimizer once: total = M (L block + embed/head) (+ optimizer). Per
device:

- FLOPs: ``torch.utils.flop_counter``'s formulas (those of
  ``FlopCounterMode``) at every op. An op on DTensors is counted at its
  global shapes, as ``FlopCounterMode`` counts it, and divided by the
  chips for ``flops_total`` (the roofline's compute term, the work spread
  evenly). That under-counts an op whose output is whole over a mesh
  axis, which every rank of that axis runs whole (the gradients of GQA's
  kv projections over "model"; the unembed's input gradient, which
  DTensor lays out whole over "data"): ``flops_with_replicas`` divides
  each op by the shares the mesh splits it into (``work_shares``)
  instead, what a device runs. An op on local tensors (the
  expert-parallel MoE block of ``models/moe.py``, attention under
  ``sharding.local_apply``) is one device's own work and counted whole
  in both; where ``local_apply`` keeps heads whole that do not split
  (musicgen's 24, hymba's 25 over 16), that whole count is 16x the even
  share.
- bytes: each op's local inputs and outputs, op by op as run (views and
  allocations excluded). This is an eager count, larger than XLA's
  post-fusion "bytes accessed" (``bytes_note`` in the record).
- collective bytes: ``roofline.CollectiveTally`` over the collectives
  DTensor's redistributions and the MoE block issue.

``memory.argument_size_in_bytes`` is exact: the local shards' bytes of the
step's arguments on rank 0. The record leaves out what only a compiler
knows (compile time, temp and output sizes, whole-program counts). An op
with no DTensor sharding rule makes the cell ``"status": "error"`` with
its traceback; nothing falls back to replication.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.config import SHAPES, get_arch, shape_applicable
from repro_torch.config.base import (ArchFamily, ModelConfig,
                                     OptimizerConfig, ShapeConfig,
                                     TrainConfig)
from repro_torch.configs import ASSIGNED_ARCHS
from repro_torch.kernels import ops
from repro_torch.launch import sharding
from repro_torch.launch.mesh import MULTI_POD, SINGLE_POD, make_mesh
from repro_torch.launch.roofline import (CollectiveTally, collective_kind,
                                         roofline_terms, tensor_bytes)
from repro_torch.launch.steps import batch_axes, input_specs, opt_state_axes
from repro_torch.models import transformer as T
from repro_torch.optim import make_optimizer
from repro_torch.tree import tree_leaves, tree_map

DEFAULT_OUT = "dryrun_results.json"
BYTES_NOTE = ("eager per-op count of local inputs and outputs; larger than "
              "a fusing compiler's bytes accessed")
SKIP_REASON = "long_500k requires sub-quadratic attention (DESIGN.md §5)"

# ops that move no data: views, allocations, autograd and collective glue
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "detach", "alias",
               "lift_fresh", "set_", "resize_", "_wrap_tensor_autograd",
               "wait_tensor", "_to_copy_meta"}


def _train_cfg(cfg: ModelConfig, shape: ShapeConfig,
               microbatches: Optional[int] = None) -> TrainConfig:
    # Big models accumulate gradients to bound live activations (each
    # microbatch gathers the FSDP weights again: the fewest that fit);
    # the 1T MoE runs Adafactor's factored second moments.
    if microbatches is None:
        big = cfg.param_count() > 3e10
        microbatches = 8 if big else (2 if cfg.param_count() > 5e9 else 1)
    opt_name = "adafactor" if cfg.param_count() > 3e11 else "adamw"
    return TrainConfig(optimizer=OptimizerConfig(name=opt_name),
                       microbatches=microbatches)


@contextlib.contextmanager
def fake_world(num_ranks: int):
    """A ``fake`` process group of ``num_ranks`` ranks, this process rank
    0, for the context only."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already running")
    dist.init_process_group("fake", store=FakeStore(), world_size=num_ranks,
                            rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def work_shares(out) -> int:
    """Into how many distinct shares the mesh splits the work of an op
    whose first DTensor output is ``out``: the product of the mesh dims on
    which it is a ``Shard`` or a ``Partial`` sum. On a ``Replicate`` dim
    every rank does the whole op."""
    return math.prod(n for n, pl in zip(out.device_mesh.shape,
                                        out.placements)
                     if not pl.is_replicate())


class _FlopCount(TorchDispatchMode):
    """Per-device FLOPs two ways. ``flops``: an op on DTensors at its
    global shapes over the chips (the work spread evenly, as the
    reference's roofline takes it); ``flops_with_replicas``: over its
    ``work_shares``, what each device runs. An op on plain (local)
    tensors counts whole in both."""

    def __init__(self, chips: int):
        super().__init__()
        self.chips = chips
        self.flops = self.flops_with_replicas = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        count = flop_registry.get(getattr(func, "_overloadpacket", None))
        if count is not None:
            n = count(*args, **kwargs, out_val=out)
            dt = next((t for t in tree_leaves(out)
                       if isinstance(t, DTensor)), None)
            self.flops += n if dt is None else n / self.chips
            self.flops_with_replicas += (n if dt is None
                                         else n / work_shares(dt))
        return out


class _Traffic(CollectiveTally):
    """The collective tally plus each local op's input and output bytes
    (DTensor's sharding propagation runs on fake tensors: not counted)."""

    def __init__(self):
        super().__init__()
        self.op_bytes = 0.0

    def _seen(self, func, types, args, kwargs, out) -> None:
        from torch._subclasses.fake_tensor import FakeTensor

        if any(issubclass(t, FakeTensor) for t in types):
            return
        if collective_kind(func):
            return super()._seen(func, types, args, kwargs, out)
        if func.is_view or func._overloadpacket.__name__ in _NO_TRAFFIC:
            return
        ins = list(args) + list((kwargs or {}).values())
        self.op_bytes += tensor_bytes(ins) + tensor_bytes(out)


@contextlib.contextmanager
def step_cost(mesh, chips: int):
    """Run model code on ``mesh``'s DTensors and count its cost: yields a
    dict filled with ``flops``, ``flops_with_replicas``, ``bytes`` and
    ``coll`` (link bytes) per device, and ``collectives`` (the tally by
    kind), when the context ends."""
    from torch.distributed.tensor.experimental import implicit_replication

    out: Dict[str, Any] = {}
    traffic, flops = _Traffic(), _FlopCount(chips)
    with sharding.use_mesh(mesh), ops.default_impl("ref"), \
            implicit_replication(), traffic, flops:
        yield out
    out.update(flops=flops.flops,
               flops_with_replicas=flops.flops_with_replicas,
               bytes=traffic.op_bytes,
               coll=traffic.total, collectives=traffic.as_dict())


def _meta(tree):
    """Specs (or tensors) as ``meta`` tensors of the same shapes."""
    if tree is None:
        return None
    if hasattr(tree, "shape"):      # a tensor or a Spec
        return torch.empty(tuple(tree.shape), dtype=tree.dtype, device="meta")
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_meta(v) for v in tree))
    return type(tree)(_meta(v) for v in tree)


def _drop_layer(tree):
    """A stacked tree's one-layer slice (leading dim dropped), as meta."""
    return tree_map(lambda t: torch.empty(tuple(t.shape[1:]), dtype=t.dtype,
                                          device="meta"), tree)


def _drop_layer_axes(axes):
    if isinstance(axes, dict):
        return {k: _drop_layer_axes(v) for k, v in axes.items()}
    if isinstance(axes, tuple) and axes and isinstance(axes[0], tuple):
        return tuple(_drop_layer_axes(a) for a in axes)
    return tuple(axes[1:])


def _grad_of(fn, tree, *extra):
    """d fn() (a scalar) / d the leaves of ``tree`` and ``extra``; every
    leaf must get a gradient (autograd raises for one that does not)."""
    leaves = [t.requires_grad_() for t in tree_leaves(tree) + list(extra)]
    with torch.enable_grad():
        torch.autograd.grad(fn(), leaves)


def _emb_parts(tree):
    return {k: tree[k] for k in ("embed", "head", "final_norm")}


def _embed_head(cfg: ModelConfig, pp, batch, mode: str):
    """The reference's eh_fn: embed (or the frontend), final norm, unembed
    (and the loss for train)."""
    if cfg.family == ArchFamily.AUDIO:
        x = batch["frontend"].to(T.compute_dtype(cfg))
    elif cfg.family == ArchFamily.VLM:
        te = T.embed_apply(cfg, pp["embed"], batch["tokens"])
        x = torch.cat([batch["frontend"].to(T.compute_dtype(cfg)), te], 1)
    else:
        x = T.embed_apply(cfg, pp["embed"], batch["tokens"])
    x = T.rmsnorm(pp["final_norm"], x, cfg.norm_eps)
    if mode == "train":
        labels = batch["labels"]
        logits = T.unembed_apply(cfg, pp["embed"], pp["head"], x[:, :-1])
        return T.cross_entropy(logits[:, -(labels.shape[1] - 1):],
                               labels[:, 1:]).mean()
    return T.unembed_apply(cfg, pp["embed"], pp["head"], x)


def component_cost_analysis(cfg: ModelConfig, shape: ShapeConfig, mesh,
                            chips: int, tc: Optional[TrainConfig]
                            ) -> Dict[str, float]:
    """Whole-step FLOPs, bytes and collective bytes per device from one
    block, the embed and head and the optimizer (module docstring)."""
    dist = sharding.distribute_tree
    params = T.lm_param_shapes(cfg)
    axes = T.lm_param_axes(cfg)
    L = T.num_blocks(cfg)
    block = dist(mesh, _drop_layer(params["blocks"]),
                 _drop_layer_axes(axes["blocks"]))
    M = tc.microbatches if (tc and shape.mode == "train") else 1
    B, S = shape.global_batch // M, shape.seq_len
    act = T.compute_dtype(cfg)
    dist1 = sharding.distribute
    keys = ("flops", "flops_with_replicas", "bytes", "coll")

    def cost(fn):
        with step_cost(mesh, chips) as c:
            fn()
        return c

    emb = dist(mesh, _emb_parts(params), _emb_parts(axes))
    if shape.mode in ("train", "prefill"):
        x = dist1(mesh, torch.empty((B, S, cfg.d_model), dtype=act,
                                    device="meta"), ("batch", None, None))
        pos = dist1(mesh, torch.empty((B, S), dtype=torch.int32,
                                      device="meta"), ("batch", None))
        with torch.no_grad():
            fwd = cost(lambda: T._block_apply(cfg, block, x, pos))
        if shape.mode == "train":
            grd = cost(lambda: _grad_of(lambda: T._block_apply(
                cfg, block, x, pos).float().square().sum(), block, x))
            per_block = {k: fwd[k] + grd[k] if cfg.remat else grd[k]
                         for k in keys}
        else:
            per_block = fwd
        mb = ShapeConfig(shape.name, S, B, shape.mode)
        batch = dist(mesh, _meta(input_specs(cfg, mb)), batch_axes(cfg, mb))
        if shape.mode == "train":
            # an audio model trains on frames: its token table is unused
            used = ({k: v for k, v in emb.items() if k != "embed"}
                    if cfg.family == ArchFamily.AUDIO else emb)
            eh = cost(lambda: _grad_of(lambda: _embed_head(
                cfg, emb, batch, "train"), used))
        else:
            with torch.no_grad():
                eh = cost(lambda: _embed_head(cfg, emb, batch, "prefill"))
        total = {k: M * (L * per_block[k] + eh[k]) for k in keys}
        if shape.mode == "train":
            opt_init, opt_update = make_optimizer(tc.optimizer)
            p = dist(mesh, params, axes)
            g = dist(mesh, params, axes)
            st = dist(mesh, _meta(opt_init(params)),
                      opt_state_axes(cfg, axes, tc.optimizer))

            def opt_fn():
                up, _ = opt_update(g, st, p)
                tree_map(lambda a, u: (a.float() + u.float()).to(a.dtype),
                         p, up)
            with torch.no_grad():
                opt = cost(opt_fn)
            total = {k: total[k] + opt[k] for k in keys}
        return total

    # decode: one block's step x L, then embed and head
    state = T.init_decode_state(cfg, B, S, device="meta")
    st = dist(mesh, _drop_layer(state), _drop_layer_axes(
        T.decode_state_axes(cfg)))
    x1 = dist1(mesh, torch.empty((B, 1, cfg.d_model), dtype=act,
                                 device="meta"), ("cache_batch", None, None))
    ln = dist1(mesh, torch.empty((B,), dtype=torch.int32, device="meta"),
               ("cache_batch",))
    with torch.no_grad():
        dec = cost(lambda: T._block_decode(cfg, block, x1, st, ln))
        if cfg.family == ArchFamily.AUDIO:
            tok = dist1(mesh, torch.empty((B, cfg.d_model), dtype=act,
                                          device="meta"),
                        ("cache_batch", None))
        else:
            tok = dist1(mesh, torch.empty((B,), dtype=torch.int32,
                                          device="meta"), ("cache_batch",))

        def eh_dec():
            if cfg.family == ArchFamily.AUDIO:
                h = tok.to(act)[:, None, :]
            else:
                h = T.embed_apply(cfg, emb["embed"], tok[:, None])
            h = T.rmsnorm(emb["final_norm"], h, cfg.norm_eps)
            return T.unembed_apply(cfg, emb["embed"], emb["head"], h)
        eh = cost(eh_dec)
    return {k: L * dec[k] + eh[k] for k in keys}


def _actual_params(params_shapes) -> int:
    return int(sum(t.numel() for t in tree_leaves(params_shapes)))


def _actual_active_params(cfg: ModelConfig, params_shapes) -> int:
    """Total params minus the unactivated expert fraction (per token)."""
    total = _actual_params(params_shapes)
    if not cfg.is_moe:
        return total
    moe = params_shapes["blocks"].get("moe", {})
    expert = sum(moe[k].numel() for k in ("w_gate", "w_up", "w_down")
                 if k in moe)
    inactive = (expert * (cfg.num_experts - cfg.experts_per_token)
                / cfg.num_experts)
    return int(total - inactive)


def step_arguments(cfg: ModelConfig, shape: ShapeConfig, mesh,
                   tc: Optional[TrainConfig]):
    """The step's arguments as meta DTensors at their resolved placements:
    (params, opt_state, batch) for train, (params, batch) for prefill,
    (params, state, tokens, length) for decode."""
    dist = sharding.distribute_tree
    params = T.lm_param_shapes(cfg)
    axes = T.lm_param_axes(cfg)
    specs = input_specs(cfg, shape)
    b_axes = batch_axes(cfg, shape)
    p = dist(mesh, params, axes)
    if shape.mode == "train":
        opt_init, _ = make_optimizer(tc.optimizer)
        st = dist(mesh, _meta(opt_init(params)),
                  opt_state_axes(cfg, axes, tc.optimizer))
        return p, st, dist(mesh, _meta(specs), b_axes)
    if shape.mode == "prefill":
        return p, dist(mesh, _meta(specs), b_axes)
    return (p,) + tuple(dist(mesh, _meta(specs[k]), b_axes[k])
                        for k in ("state", "tokens", "length"))


def laid_out_as(tree, like):
    """Every DTensor of ``tree`` redistributed to the placements of the
    matching leaf of ``like`` (``jit``'s ``out_shardings``)."""
    return tree_map(lambda t, ref: t.redistribute(ref.device_mesh,
                                                  ref.placements), tree, like)


def argument_bytes(args) -> int:
    """Rank 0's bytes of ``args``' local shards."""
    return int(sum(t.to_local().numel() * t.element_size()
                   for t in tree_leaves(list(args))))


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               microbatches: Optional[int] = None) -> Dict[str, Any]:
    """Cost one cell on its fake world; returns the dry-run record."""
    cfg = get_arch(arch)
    if cfg.family == ArchFamily.CNN:
        raise SystemExit(f"{arch} is a federated-plane CNN config; the dry-run "
                         "covers the assigned LM architectures")
    shape = SHAPES[shape_name]
    if not shape_applicable(cfg, shape):
        return {"status": "skipped", "reason": SKIP_REASON}
    mc = MULTI_POD if multi_pod else SINGLE_POD
    tc = _train_cfg(cfg, shape, microbatches) if shape.mode == "train" \
        else None
    t0 = time.time()
    with fake_world(mc.num_devices):
        mesh = make_mesh(mc, device_type="cpu")
        args = step_arguments(cfg, shape, mesh, tc)
        arg_bytes = argument_bytes(args)
        del args
        comp = component_cost_analysis(cfg, shape, mesh, mc.num_devices, tc)
    params = T.lm_param_shapes(cfg)
    rec = {
        "status": "ok",
        "arch": arch,
        "shape": shape_name,
        "mesh": "multi" if multi_pod else "single",
        "num_devices": mc.num_devices,
        "trace_s": round(time.time() - t0, 1),
        "flops_total": comp["flops"],
        "flops_with_replicas": comp["flops_with_replicas"],
        "bytes_total": comp["bytes"],
        "bytes_note": BYTES_NOTE,
        "collective_bytes": {"total": comp["coll"]},
        "memory": {"argument_size_in_bytes": float(arg_bytes)},
        "params": _actual_params(params),
        "active_params": _actual_active_params(cfg, params),
        "tokens": shape.tokens if shape.mode != "decode"
        else shape.global_batch,
        "mode": shape.mode,
    }
    if tc is not None:
        rec["microbatches"] = tc.microbatches
        rec["optimizer"] = tc.optimizer.name
    rec["roofline"] = roofline_terms(rec)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--microbatches", type=int, default=None)
    args = ap.parse_args(argv)

    results: Dict[str, Any] = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)

    archs = list(ASSIGNED_ARCHS) if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                key = f"{arch}|{shape}|{'multi' if mp else 'single'}"
                if results.get(key, {}).get("status") == "ok":
                    print(f"[skip cached] {key}")
                    continue
                print(f"[trace] {key} ...", flush=True)
                try:
                    rec = lower_cell(arch, shape, mp, args.microbatches)
                except Exception as e:
                    rec = {"status": "error",
                           "error": f"{type(e).__name__}: {e}"[:2000],
                           "traceback": traceback.format_exc()[-2000:]}
                results[key] = rec
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
                if rec["status"] == "ok":
                    r = rec["roofline"]
                    print(f"  ok: trace={rec['trace_s']}s "
                          f"compute={r['compute_s']:.4f}s "
                          f"memory={r['memory_s']:.4f}s "
                          f"collective={r['collective_s']:.4f}s "
                          f"dominant={r['dominant']}")
                else:
                    print(f"  {rec['status']}: "
                          f"{rec.get('reason', rec.get('error'))[:300]}")

    counts = {s: sum(1 for v in results.values() if v.get("status") == s)
              for s in ("ok", "skipped", "error")}
    print(f"\n=== dry-run summary: {counts['ok']} ok, {counts['skipped']} "
          f"skipped, {counts['error']} errors ===")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
