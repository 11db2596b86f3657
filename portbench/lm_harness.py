"""One run of an ``lm_train`` cell: the port's LM training step
(``launch/steps.py::make_train_step``) driven in a closed loop.

Set-up loads the configuration's reference file once, checks the
configuration's ``model`` block against the program's registry and the
reference file's parameter layout against the program's
(``lm_param_shapes``), makes the initial weights on the device from
``--seed`` (one draw a leaf from a ``torch.Generator``, each with the
reference file's standard deviation, stored in the model's
``param_dtype``), builds ``make_train_step`` and ``opt_init``, and trains
the traffic's ``warmup_steps`` steps under the program's default kernels.
Step ``i`` trains ``batch`` rows of ``seq_len`` token ids over the model's
vocabulary, drawn on the device from ``--seed`` and ``i``, so every row is
new and both sides read the same batches. The program's parameters before
each of the first ``check_steps`` steps but the first (which are the
initial weights, drawn again) are copied to the host.

The window steps the same object on, each step's end stamped with a CUDA
event and no host sync, until the first step enqueued after
``--seconds``; the device is synchronised at both ends. The rate is the
sequences trained in the window's first ``--seconds``
(``harness.samples_in``: the step running at that instant by its elapsed
share) over ``--seconds``.

Then the program's state (parameters, AdamW moments, step count) is
copied to the host and the program trains one more step from it, the
check step. Once its state is freed, the reference file, in float32 with
TF32 off, (1) takes the loss and the gradient at the program's parameters
before each checked step, on that step's batch; (2) trains the
``check_steps`` steps on its own from the initial weights; (3) trains the
check step from the host copy. Seven numbers compare the two
(``NUMBERS``): the worst relative gap of a checked step's loss (1); that
of the first step's global gradient norm, and the worst of every checked
step's (1, and the check step's, 3); leaf by leaf, the gap between
the norms of the first gradient as the optimizer got it (the program's
from its first moment after one step, ``m / (1 - b1)``) and of the
parameters' change over the ``check_steps`` steps (2), against the
reference's norm of that leaf or of the median leaf, whichever is larger;
and the check step's loss and change (3). Leaves whose first gradient the
reference reads under a thousandth of the median leaf's are left out of
the leaf gaps.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from portbench import check, guard, manifest, tracing
from portbench.harness import (Failed, _marker, _seconds_since, checks,
                               result, samples_in)
from portbench.reference import lm_train as ref_train
from portbench.reference import pool as ref_pool

NUMBERS = ("loss_gap", "grad_norm1_gap", "grad_norm_gap", "grad1_gap",
           "update_gap", "window_loss_gap", "window_update_gap")
#: NVIDIA H100 SXM, dense bf16 on the tensor cores (data sheet, 700 W).
PEAK_BF16_FLOPS = 989e12

HostParams = Dict[str, torch.Tensor]


def flat(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A nested dict's leaves by path (``blocks/attn/wq``), keys sorted."""
    if isinstance(tree, dict):
        out: Dict[str, torch.Tensor] = {}
        for k in sorted(tree):
            out.update(flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def rebuilt(tree, fn: Callable, prefix: str = ""):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: rebuilt(v, fn, f"{prefix}{k}/") for k, v in tree.items()}
    return fn(prefix[:-1], tree)


def reference(cell: manifest.Cell):
    """The configuration's reference file (``reference/<file>``)."""
    return manifest.load_module(cell.base / "reference"
                                / cell.config["reference"])


def sub_seeds(seed: int) -> Dict[str, int]:
    """The initial weights' and the batches' seeds, drawn from ``--seed``."""
    s = np.random.SeedSequence(int(seed)).generate_state(2)
    return dict(init=int(s[0]), data=int(s[1]))


def _generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def init_leaves(arch, model: dict, seed: int, device
                ) -> Iterator[Tuple[str, torch.Tensor]]:
    """The initial weights, leaf by leaf in sorted order, in the model's
    ``param_dtype``: ones where the reference file gives no standard
    deviation (norm scales), else one normal draw of the leaf's shape,
    scaled."""
    g = _generator(seed, device)
    dtype = getattr(torch, model["param_dtype"])
    for path, shape in arch.param_shapes(model).items():
        std = arch.init_std(path, shape)
        if std is None:
            t = torch.ones(shape, dtype=torch.float32, device=device)
        else:
            t = torch.randn(shape, generator=g, dtype=torch.float32,
                            device=device).mul_(std)
        yield path, t.to(dtype)


def tokens(seeds: Dict[str, int], i: int, traffic: dict, vocab: int,
           device) -> torch.Tensor:
    """Step ``i``'s batch: (batch, seq_len) int32 ids in [0, vocab)."""
    s = int(np.random.SeedSequence([seeds["data"], i]).generate_state(1)[0])
    return torch.randint(0, vocab, (traffic["batch"], traffic["seq_len"]),
                         generator=_generator(s, device), device=device,
                         dtype=torch.int32)


def _plain(d: dict) -> dict:
    return json.loads(json.dumps(d))


def model_config(cell: manifest.Cell):
    """The program's ``ModelConfig`` of the cell's ``arch``; refuses one
    whose fields differ from the configuration file's ``model`` block."""
    from repro_torch.config.registry import get_arch

    cfg = get_arch(cell.config["arch"])
    have, want = _plain(dataclasses.asdict(cfg)), cell.config["model"]
    diff = sorted(k for k in set(have) | set(want)
                  if have.get(k, "<missing>") != want.get(k, "<missing>"))
    if diff:
        raise Failed(f"{cell.config['arch']}: the program's config differs "
                     f"from configs/{cell.config['name']}.json in "
                     + ", ".join(f"{k} ({have.get(k)!r} there, "
                                 f"{want.get(k)!r} here)" for k in diff))
    return cfg


@dataclasses.dataclass
class Start:
    """A side's own training from the initial weights: its first step's
    loss and global gradient norm, each leaf's first gradient norm as the
    optimizer got it, and each leaf's change over the checked steps."""

    loss: float
    grad_norm: float
    grad1: Dict[str, float]
    update: Dict[str, float]


@dataclasses.dataclass
class Readings:
    """One side's checked steps, each at the program's parameters before
    it (the first at the initial weights), and its check step.
    ``window_grads``: each leaf's gradient norm as the optimizer got it
    there (the reference's decide which leaves count)."""

    losses: List[float]
    grad_norms: List[float]
    grad1: Dict[str, float]
    update: Dict[str, float]
    window_loss: float = math.nan
    window_grad_norm: float = math.nan
    window_update: Dict[str, float] = None
    window_grads: Dict[str, float] = None


@dataclasses.dataclass
class HostState:
    """The program's state before the check step, on the host."""

    params: HostParams
    m: HostParams
    v: HostParams
    step: int          # steps trained
    index: int         # the check step's batch


class Program:
    """The cell's training step and its state on ``device``."""

    def __init__(self, cell: manifest.Cell, arch, seed: int, device: str):
        from repro_torch.config.base import OptimizerConfig, TrainConfig
        from repro_torch.launch import steps
        from repro_torch.models.transformer import lm_param_shapes

        c = cell.config
        self.cell, self.arch, self.device = cell, arch, device
        self.model, self.traffic = c["model"], cell.traffic
        self.opt = c["optimizer"]
        if self.opt.get("name") != "adamw":
            raise Failed(f"{c['name']}: lm_train trains AdamW, not "
                         f"{self.opt.get('name')!r}")
        self.seeds = sub_seeds(seed)
        cfg = model_config(cell)
        guard.check("after the program's import")
        layout = lm_param_shapes(cfg)
        shapes = {k: tuple(t.shape) for k, t in flat(layout).items()}
        if shapes != arch.param_shapes(self.model):
            raise Failed(f"{c['name']}: the program's parameters "
                         f"{shapes} are not the reference's")
        leaves = dict(init_leaves(arch, self.model, self.seeds["init"],
                                  device))
        self.params = rebuilt(layout, lambda path, _: leaves.pop(path))
        self.step, opt_init = steps.make_train_step(cfg, TrainConfig(
            optimizer=OptimizerConfig(**self.opt),
            microbatches=int(c["microbatches"])))
        self.opt_state = opt_init(self.params)
        self.trained = 0

    def batch(self, i: int) -> torch.Tensor:
        return tokens(self.seeds, i, self.traffic, self.model["vocab_size"],
                      self.device)

    def train(self, toks: torch.Tensor) -> dict:
        """One step of the program on ``toks``; its loss and gradient norm
        stay on the device."""
        self.params, self.opt_state, m = self.step(
            self.params, self.opt_state, {"tokens": toks, "labels": toks})
        self.trained += 1
        return m

    def first_moment(self) -> Dict[str, torch.Tensor]:
        return flat(self.opt_state.inner[0])


def on_host(params) -> HostParams:
    return {k: t.detach().cpu() for k, t in flat(params).items()}


def change_norms(params: Dict[str, torch.Tensor],
                 start: Iterator[Tuple[str, torch.Tensor]]
                 ) -> Dict[str, float]:
    """Each leaf's norm of ``params`` less its ``start``, leaf by leaf."""
    return {k: ref_train.leaf_norm(params[k].float() - p0.float())
            for k, p0 in start}


def warm_up(prog: Program) -> Tuple[Readings, List[HostParams]]:
    """Train the warm-up; read the program's side of its checked steps,
    and keep its parameters before the second to the last of them."""
    K, W = int(prog.traffic["check_steps"]), int(prog.traffic["warmup_steps"])
    if not 1 <= K <= W:
        raise Failed(f"check_steps {K} must lie in 1..warmup_steps {W}")
    metrics, points, b1 = [], [], prog.opt["b1"]
    for i in range(W):
        if 0 < i < K:
            points.append(on_host(prog.params))
        metrics.append(prog.train(prog.batch(i)))
        if i == 0:
            grad1 = {k: ref_train.leaf_norm(t) / (1.0 - b1)
                     for k, t in prog.first_moment().items()}
        if i == K - 1:
            update = change_norms(flat(prog.params), init_leaves(
                prog.arch, prog.model, prog.seeds["init"], prog.device))
    side = Readings([float(m["loss"]) for m in metrics[:K]],
                    [float(m["grad_norm"]) for m in metrics[:K]],
                    grad1, update)
    return side, points


def check_step(prog: Program, side: Readings) -> HostState:
    """Copy the program's state to the host, train the check step from it,
    and read that step into ``side``."""
    m, v = prog.opt_state.inner
    host = HostState(on_host(prog.params), on_host(m), on_host(v),
                     int(prog.opt_state.step), prog.trained)
    del m, v
    met = prog.train(prog.batch(host.index))
    side.window_update = {k: ref_train.leaf_norm(
        t.float() - host.params[k].to(device=t.device, dtype=torch.float32))
        for k, t in flat(prog.params).items()}
    side.window_loss = float(met["loss"])
    side.window_grad_norm = float(met["grad_norm"])
    return host


def _on(d: HostParams, device: str) -> Dict[str, torch.Tensor]:
    return {k: t.to(device=device, dtype=torch.float32, copy=True)
            for k, t in d.items()}


def own_start(arch, cell: manifest.Cell, seed: int, device: str,
              precision: str = "float32") -> Start:
    """The reference's ``check_steps`` steps from the initial weights on
    the same batches."""
    model, opt, seeds = cell.config["model"], cell.config["optimizer"], \
        sub_seeds(seed)
    ref_train.no_tf32()
    params = {k: t.float() for k, t in init_leaves(arch, model,
                                                    seeds["init"], device)}
    m = {k: torch.zeros_like(t) for k, t in params.items()}
    v = {k: torch.zeros_like(t) for k, t in params.items()}
    for t in range(int(cell.traffic["check_steps"])):
        r = ref_train.step(
            arch, model, opt, params, m, v, t + 1,
            tokens(seeds, t, cell.traffic, model["vocab_size"], device),
            precision)
        if t == 0:
            first = r
    del m, v
    update = change_norms(params, init_leaves(arch, model, seeds["init"],
                                              device))
    return Start(first.loss, first.grad_norm, first.grad_norms, update)


def at_points(arch, cell: manifest.Cell, seed: int,
              points: List[HostParams], device: str,
              precision: str = "float32") -> Tuple[List[float], List[float]]:
    """The reference's loss and global gradient norm at each of the
    program's ``points`` (its parameters before checked steps 2, 3, ...),
    on that step's batch."""
    model, seeds = cell.config["model"], sub_seeds(seed)
    ref_train.no_tf32()
    losses, norms = [], []
    for i, point in enumerate(points, start=1):
        loss, norm = ref_train.loss_and_norm(
            arch, model, _on(point, device),
            tokens(seeds, i, cell.traffic, model["vocab_size"], device),
            precision)
        losses.append(loss)
        norms.append(norm)
    return losses, norms


def at_check_step(arch, cell: manifest.Cell, seed: int, host: HostState,
                  device: str, precision: str = "float32") -> dict:
    """The reference's check step from the program's host state: the
    ``window_*`` fields of ``Readings``."""
    model = cell.config["model"]
    ref_train.no_tf32()
    params, m, v = (_on(d, device) for d in (host.params, host.m, host.v))
    r = ref_train.step(arch, model, cell.config["optimizer"], params, m, v,
                       host.step + 1,
                       tokens(sub_seeds(seed), host.index, cell.traffic,
                              model["vocab_size"], device), precision)
    del m, v
    return dict(window_loss=r.loss, window_grad_norm=r.grad_norm,
                window_grads=r.grad_norms,
                window_update={k: ref_train.leaf_norm(
                    params[k] - host.params[k].to(device=device,
                                                  dtype=torch.float32))
                    for k in params})


def follow(arch, cell: manifest.Cell, seed: int, points: List[HostParams],
           host: HostState, device: str, precision: str = "float32",
           start: Optional[Start] = None) -> Readings:
    """The reference's readings beside the program's: its own ``start``
    (trained here unless given), then at the program's ``points`` and from
    its ``host`` state."""
    if start is None:
        start = own_start(arch, cell, seed, device, precision)
        _free(device)
    losses, norms = at_points(arch, cell, seed, points, device, precision)
    _free(device)
    window = at_check_step(arch, cell, seed, host, device, precision)
    _free(device)
    return Readings([start.loss] + losses, [start.grad_norm] + norms,
                    start.grad1, start.update, **window)


def _leaf_gap(side: Dict[str, float], ref: Dict[str, float],
              grads: Dict[str, float]) -> float:
    keys = sorted(ref)
    g = np.array([grads[k] for k in keys])
    keep = g >= check.STILL * np.median(g)
    return check._leaf_gap(np.array([side.get(k, math.nan) for k in keys]),
                           np.array([ref[k] for k in keys]), keep)


def numbers(side: Readings, ref: Readings) -> Dict[str, float]:
    """``NUMBERS``: ``side`` against the reference ``ref``."""
    gap = ref_pool.rel_gap
    norms = zip(side.grad_norms + [side.window_grad_norm],
                ref.grad_norms + [ref.window_grad_norm])
    return dict(
        loss_gap=max(gap(a, b) for a, b in zip(side.losses, ref.losses)),
        grad_norm1_gap=gap(side.grad_norms[0], ref.grad_norms[0]),
        grad_norm_gap=max(gap(a, b) for a, b in norms),
        grad1_gap=_leaf_gap(side.grad1, ref.grad1, ref.grad1),
        update_gap=_leaf_gap(side.update, ref.update, ref.grad1),
        window_loss_gap=gap(side.window_loss, ref.window_loss),
        window_update_gap=_leaf_gap(side.window_update, ref.window_update,
                                    ref.window_grads))


@dataclasses.dataclass
class RunData:
    """What the per-layer readers read (``portbench/metrics/*.py``)."""

    window_s: float
    steps: int                  # steps trained in the window
    sequences: int              # rows of seq_len tokens
    tokens: int
    flops: int                  # matmul FLOPs (the reference's step_flops)
    window_peak_bytes: int
    device_ops: list = None     # tracing.DeviceOp, sorted
    busy_s: float = None
    spans: list = None          # tracing.Span: the harness's feed and step
    peak_flops: float = PEAK_BF16_FLOPS


def _free(device: str) -> None:
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()


def run(cell: manifest.Cell, seed: int, seconds: float, trace: bool,
        process_start: float, device: str = "cuda") -> dict:
    """One run; returns the result object that ``run.py`` prints."""
    cuda = device == "cuda"
    if cuda:
        if not torch.cuda.is_available():
            raise Failed("no CUDA device")
        if torch.cuda.device_count() < cell.chips:
            raise Failed(f"{torch.cuda.device_count()} CUDA devices, the "
                         f"cell asks for {cell.chips}")
    if cell.config.get("tf32") is False:
        ref_train.no_tf32()
    phases = {"start_s": time.time() - process_start}
    t = time.perf_counter()
    arch = reference(cell)
    prog = Program(cell, arch, seed, device)
    B, S = int(cell.traffic["batch"]), int(cell.traffic["seq_len"])
    flops_per_step = int(arch.step_flops(prog.model, B, S))
    phases["build_s"] = time.perf_counter() - t
    t = time.perf_counter()
    side, points = warm_up(prog)
    setup_peak = 0
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    phases["warmup_s"] = time.perf_counter() - t

    prof = None
    if trace and cuda:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.__enter__()
    mark = _marker(cuda)
    offset_ns = time.time_ns() - time.perf_counter_ns()
    start = mark()
    t0 = time.perf_counter()
    setup_s = time.time() - process_start
    deadline = t0 + seconds
    ends, losses, stamps = [], [], []
    while True:
        a = time.perf_counter()
        toks = prog.batch(prog.trained)
        b = time.perf_counter()
        met = prog.train(toks)
        e = time.perf_counter()
        ends.append(mark())
        losses.append(met["loss"])
        stamps += [("feed", a, b), ("train_step", b, e)]
        if e >= deadline:
            break
    if cuda:
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    window_s = t1 - t0
    steps = len(ends)
    ends = [_seconds_since(start, m) for m in ends]
    in_window = samples_in(ends, [B] * steps, seconds)
    run_data = RunData(
        window_s=window_s, steps=steps, sequences=steps * B,
        tokens=steps * B * S, flops=steps * flops_per_step,
        window_peak_bytes=(torch.cuda.max_memory_allocated() if cuda else 0),
        spans=[tracing.Span(n, int(a * 1e9) + offset_ns,
                            int(b * 1e9) + offset_ns) for n, a, b in stamps])
    if trace:
        ops = []
        if prof is not None:
            prof.__exit__(None, None, None)
            ops = tracing.device_ops(prof)
            del prof
        run_data.device_ops = ops
        run_data.busy_s = tracing.busy_seconds(tracing.busy_intervals(ops))
    guard.check("after the window")
    losses = [float(x) for x in losses]
    failed = sum(1 for x in losses if not math.isfinite(x))
    memory_peak = max(setup_peak, run_data.window_peak_bytes)

    t = time.perf_counter()
    host = check_step(prog, side)
    del prog
    _free(device)
    phases["check_step_s"] = time.perf_counter() - t
    t = time.perf_counter()
    ref = follow(arch, cell, seed, points, host, device)
    del points, host
    _free(device)
    nums = numbers(side, ref)
    correct = check.verdict(nums, cell.limits)
    phases["reference_s"] = time.perf_counter() - t

    out = result(cell, correct=correct, attempted=steps, failed=failed,
                 run_data=run_data, memory_peak=memory_peak,
                 values={"train_samples_per_s": in_window / seconds,
                         "setup_s": setup_s},
                 trace=trace, cuda=cuda, lo_ns=int(t0 * 1e9) + offset_ns,
                 outside="harness")
    out["window"] = {
        "seconds": window_s, "step_ends": ends, "steps": steps,
        "sequences_in_seconds": in_window, "tokens": run_data.tokens,
        "tokens_per_s": in_window * S / seconds, "flops": run_data.flops,
        "flops_per_step": flops_per_step,
        "warmup_steps": int(cell.traffic["warmup_steps"]),
        "window_losses": [losses[0], losses[-1]],
        "readings": {"program": _summary(side), "reference": _summary(ref)},
        "phases": phases}
    out["checks"] = checks(nums, cell.limits)
    return out


def _summary(r: Readings) -> dict:
    return {"losses": r.losses, "grad_norms": r.grad_norms,
            "check_loss": r.window_loss,
            "check_grad_norm": r.window_grad_norm}
