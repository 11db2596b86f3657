#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--out details.json]

Needs one CUDA card and ``nvcc``; imports nothing of JAX and nothing of the
reference package. Every phase prints one JSON line; any failure exits
non-zero with a traceback, and no phase's failure is caught.

1. device  — the card's name and power limit (``nvidia-smi``) and the
   kernel build, from the checkout's sources, one ``nvcc`` per source.
2. kernels — each kernel against its plain PyTorch version on the card, at
   the shapes the main path gives it and at ragged and edge-case shapes;
   columns 0 and 1 of ``plan_stats`` exact, column 2 within
   ``1e-5 * max(1, sum |w| over the selected devices)``. Times (CUDA
   events, warm-up then the median) of the kernel, the plain version and
   the host-to-device copy of the plans, beside the bound.
3. main    — the ``fleet-scale`` preset (K = 10,000, n_sel = 100, 2 jobs x 5
   rounds) with the genetic host search (population 512, 12 generations)
   and ``scoring_backend="cuda"``, through ``ExperimentSpec.build/run`` on
   the card: the kernel must launch 13 times per decision; the same spec on
   the ``torch`` backend must give identical device ids and round times
   and est_cost within 1e-5. Greedy on the same preset covers the index
   form on the card and must match the numpy backend's records.

The line before the last is the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints
them; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (data sheet)
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
SUM_RTOL = 1e-5


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


SLEEP_CYCLES = 100_000_000    # ~50-70 ms of GPU clock


def cuda_time_ms(torch, fn, inner: int, reps: int = 7,
                 hide_host: bool = True) -> float:
    """Median over ``reps`` of the mean device time of ``inner`` back-to-back
    calls, by CUDA events, after a warm-up. With ``hide_host`` a sleep kernel
    is queued first, so the host has enqueued every launch before the start
    event runs and the events time the device work, not Python's launch
    overhead."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if hide_host:
            torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    return statistics.median(samples)


# ---- phase 2 -------------------------------------------------------------

def make_inputs(torch, dev, P, K, density, seed, edges=False):
    """Times, centred-count weights (as the cuda backend builds them) and
    plans for one shape, made on the card from ``seed``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    times = torch.rand(K, device=dev, generator=g) * 100.0 + 0.1
    counts = torch.randint(0, 6, (K,), device=dev, generator=g).double()
    weights = (2.0 * (counts - counts.mean()) + 1.0).float()
    plans = torch.rand((P, K), device=dev, generator=g) < density
    if edges:
        # +inf times (crashed devices) on devices no ordinary row selects;
        # one empty row and one row selecting every device.
        inf_cols = torch.arange(3, K, 41, device=dev)
        times[inf_cols] = torch.inf
        plans[:, inf_cols] = False
        plans[0] = False
        plans[1] = True
    return times, weights, plans.view(torch.int8)


def check_stats(torch, got, exp, weights, plans) -> float:
    got, exp = got.cpu(), exp.cpu()
    if not torch.equal(got[:, 0], exp[:, 0]):
        raise AssertionError("column 0 (masked max) differs from plain")
    if not torch.equal(got[:, 1], exp[:, 1]):
        raise AssertionError("column 1 (count) differs from plain")
    scale = torch.where(plans != 0, weights.abs()[None, :], 0.0).sum(
        1, dtype=torch.float64).clamp(min=1.0).cpu()
    err = (got[:, 2].double() - exp[:, 2].double()).abs()
    if not bool((err <= SUM_RTOL * scale).all()):
        raise AssertionError(f"column 2 off by {float(err.max())}")
    return float(err.max()) if err.numel() else 0.0


def phase_kernels(torch, dev) -> dict:
    from repro_torch.core import scoring
    from repro_torch.kernels import sched_score

    shapes = [
        # (label, P, K, density, edges)
        ("sa", 1, 10_000, 0.01, False),
        ("genetic-fleet-scale", 512, 10_000, 0.01, False),
        ("readme-fleet-block", 4096, 100_000, 0.01, False),
        ("ragged", 37, 1001, 0.10, True),
        ("edges-aligned", 64, 10_000, 0.01, True),
    ]
    rows = []
    for i, (label, P, K, density, edges) in enumerate(shapes):
        times, weights, plans = make_inputs(torch, dev, P, K, density,
                                            seed=1000 + i, edges=edges)
        got = sched_score.plan_stats(times, weights, plans)
        exp = sched_score.plan_stats_ref(times, weights, plans)
        torch.cuda.synchronize()
        err = check_stats(torch, got, exp, weights, plans)
        host_plans = (plans.cpu().numpy() != 0)  # numpy bool, as searchers hold
        big = P * K >= 10 ** 8
        kernel_ms = cuda_time_ms(
            torch, lambda: sched_score.plan_stats(times, weights, plans),
            inner=5 if big else 50)
        plain_ms = cuda_time_ms(
            torch, lambda: sched_score.plan_stats_ref(times, weights, plans),
            inner=2 if big else 20)
        # A copy from pageable host memory blocks the host: nothing to hide.
        h2d_ms = cuda_time_ms(
            torch, lambda: scoring.h2d(host_plans.view("int8"), dev),
            inner=2 if big else 20, hide_host=False)
        nbytes = P * K + 8 * K + 12 * P
        ops = 3 * P * K
        bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
        rows.append(dict(
            label=label, shape=[P, K], max_abs_err=err,
            kernel_ms=kernel_ms, plain_ms=plain_ms, h2d_ms=h2d_ms,
            bound_ms=bound_ms,
            bound_by=("bytes" if nbytes / HBM_BYTES_PER_S
                      >= ops / F32_OPS_PER_S else "operations"),
            selected=int((plans != 0).sum())))
        del times, weights, plans, got, exp, host_plans
        torch.cuda.empty_cache()
    return {"plan_stats": rows}


# ---- phase 3 -------------------------------------------------------------

class ScoringClock:
    """Host time inside the scoring entry points (``score_plans``,
    ``score_plan_indices``) and inside their host-to-device copies
    (``h2d``), with the stream drained around each so the copy times are
    the copies'. Installed only for the measured run."""

    ENTRIES = ("score_plans", "score_plan_indices")

    def __init__(self, torch, scoring):
        self.torch, self.scoring = torch, scoring
        self.score_s = 0.0
        self.copy_s = 0.0
        self._orig = {n: getattr(scoring, n) for n in self.ENTRIES + ("h2d",)}

    def _timed(self, fn, attr):
        sync = self.torch.cuda.synchronize

        def wrapper(*a, **kw):
            sync()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            sync()
            setattr(self, attr, getattr(self, attr) + time.perf_counter() - t0)
            return out

        return wrapper

    def __enter__(self):
        for name in self.ENTRIES:
            setattr(self.scoring, name, self._timed(self._orig[name],
                                                    "score_s"))
        self.scoring.h2d = self._timed(self._orig["h2d"], "copy_s")
        return self

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            setattr(self.scoring, name, fn)
        return False


def fleet_spec(scheduler: str, backend: str):
    from repro_torch.experiment.presets import get_preset

    return get_preset("fleet-scale", scheduler=scheduler,
                      search_backend="host", scoring_backend=backend)


def check_records(records, n_sel: int, K: int) -> None:
    import numpy as np

    if not records:
        raise AssertionError("the run produced no records")
    for r in records:
        ids = np.asarray(r.device_ids)
        if ids.size != n_sel or np.unique(ids).size != n_sel:
            raise AssertionError(f"record {r.job}/{r.round_idx}: "
                                 f"{ids.size} ids, expected {n_sel} distinct")
        if ids.min() < 0 or ids.max() >= K:
            raise AssertionError("device id out of range")
        vals = (r.round_time, r.cost, r.fairness, r.accuracy, r.est_cost)
        if not all(v is not None and np.isfinite(v) for v in vals):
            raise AssertionError(f"non-finite record values {vals}")
        if r.round_time <= 0:
            raise AssertionError("round_time must be positive")


def compare_runs(a, b) -> float:
    """Identical device ids and round times; est_cost within
    ``1e-5 + 1e-5 * |est_cost|`` (the scoring tolerance)."""
    import numpy as np

    if len(a) != len(b):
        raise AssertionError(f"{len(a)} vs {len(b)} records")
    worst = 0.0
    for ra, rb in zip(a, b):
        if not np.array_equal(ra.device_ids, rb.device_ids):
            raise AssertionError(f"device_ids differ at job {ra.job} round "
                                 f"{ra.round_idx}")
        if ra.round_time != rb.round_time:
            raise AssertionError(f"round_time differs at job {ra.job} round "
                                 f"{ra.round_idx}")
        d = abs(ra.est_cost - rb.est_cost)
        worst = max(worst, d)
        if d > 1e-5 + 1e-5 * abs(rb.est_cost):
            raise AssertionError(f"est_cost differs by {d}")
    return worst


def phase_main(torch) -> dict:
    from repro_torch.core import scoring
    from repro_torch.kernels import sched_score

    spec = fleet_spec("genetic", "cuda")
    K, n_sel = spec.effective_num_devices(), spec.effective_n_sel()
    exp = spec.build(device="cuda")
    sched = exp.engine.scheduler
    decisions = 0
    schedule = sched.schedule

    def counted(ctx):
        nonlocal decisions
        decisions += 1
        return schedule(ctx)

    sched.schedule = counted
    with ScoringClock(torch, scoring) as clock:
        sched_score.launches = 0
        t0 = time.perf_counter()
        result = exp.run()
        wall_s = time.perf_counter() - t0
        launches = sched_score.launches
    expected = (sched.generations + 1) * decisions
    if decisions == 0 or launches != expected:
        raise AssertionError(f"plan_stats launched {launches} times for "
                             f"{decisions} decisions, expected {expected}")
    check_records(result.records, n_sel, K)

    t0 = time.perf_counter()
    torch_run = fleet_spec("genetic", "torch").run(device="cuda")
    torch_wall_s = time.perf_counter() - t0
    est_diff = compare_runs(result.records, torch_run.records)

    greedy = fleet_spec("greedy", "cuda").run(device="cuda")
    check_records(greedy.records, n_sel, K)
    greedy_np = fleet_spec("greedy", "numpy").run(device="cuda")
    greedy_diff = compare_runs(greedy_np.records, greedy.records)
    return dict(
        preset="fleet-scale", scheduler="genetic", search_backend="host",
        K=K, n_sel=n_sel, population=sched.population,
        generations=sched.generations, rounds=len(result.records),
        decisions=decisions, launches=launches,
        launches_per_decision=launches / decisions,
        wall_s=wall_s, torch_backend_wall_s=torch_wall_s,
        scoring_s=clock.score_s, copy_s=clock.copy_s,
        copy_share_of_scoring=(clock.copy_s / clock.score_s
                               if clock.score_s else None),
        torch_vs_cuda_max_est_cost_diff=est_diff,
        greedy_rounds=len(greedy.records),
        greedy_vs_numpy_max_est_cost_diff=greedy_diff)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every phase's details here")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs a CUDA card", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no port sources under {SRC}; run it from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    libs = build.build_all()
    build_s = time.perf_counter() - t0
    device = dict(phase="device", nvidia_smi=smi,
                  name=torch.cuda.get_device_name(0),
                  count=torch.cuda.device_count(), torch=torch.__version__,
                  cuda=torch.version.cuda, build_s=build_s,
                  libraries=[p.name for p in libs.values()],
                  ptxas={n: log["ptxas"].strip().splitlines()[-2:]
                         for n, log in build.build_log.items()})
    emit(device)

    kern = phase_kernels(torch, dev)
    main_path = phase_main(torch)
    at = next(r for r in kern["plan_stats"]
              if r["label"] == "genetic-fleet-scale")
    kernels = [dict(
        name="plan_stats", route="cuda",
        source="src/repro_torch/kernels/csrc/sched_score.cu",
        replaces="src/repro/kernels/sched_score.py:39",
        launches=main_path["launches"],
        max_abs_err=max(r["max_abs_err"] for r in kern["plan_stats"]),
        ms=at["kernel_ms"], plain_ms=at["plain_ms"], h2d_ms=at["h2d_ms"],
        bound_ms=at["bound_ms"], bound_by=at["bound_by"], library_ms=None,
        shapes=kern["plan_stats"])]
    emit(dict(phase="kernels", kernels=kernels))
    emit(dict(phase="main", **main_path))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            dict(device=device, kernels=kernels, main=main_path), indent=1))
    print(json.dumps({"kernels": [{k: v for k, v in kr.items()
                                   if k != "shapes"} for kr in kernels]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
