"""The readings that the limits of ``limits/<cell>.json`` are set from.

    python3 portbench/control.py --workload group-a.paper \\
        --seeds 101,102,103 --control-seeds 101,102,103 \\
        --out chiprun_out/readings.jsonl

For each seed it builds the cell, drives the warm-up whose rounds the
reference follows and then one round more of each job (as the window
does, each job's parameters before and after it kept), and writes one
JSON line with the numbers of ``check.NUMBERS`` for the program against
the float32 reference (the lower readings), and, on the control seeds,
for what is put in the program's place: the reference in TF32 (``tf32``,
the control), the reference averaging only the first half of each cohort
(``half_cohort``), the program's cohorts with one device of one round
swapped for another (``altered_cohort``), the engine's round times and
costs altered (``engine_faults``), and, driven one round more of each
job, the scheduler's plan replaced by the first free devices where it is
made (``first_free``). A round that returns its state unchanged reads 1
on the update numbers by their definition. ``--skip-warmup-sides``
trains the control alone, on the extra round alone.

For an ``lm_train`` cell each seed's line holds the program's numbers
(``lm_harness.NUMBERS``) against the float32 reference after the warm-up
and one check step, and, on the control seeds, the reference in
float8_e4m3fn (matmul inputs and outputs, the residual stream and the
gradients through them) in the program's place (``float8_e4m3fn``, the
control) and each fault of ``LM_FAULTS`` planted in the program: one
block's MLP output dropped (``dropped_mlp``), a step that trains the first
half of the batch (``half_batch``), and a step that returns its state
unchanged (``unchanged_state``). ``lm_line`` reads one seed of a cell
that the caller loaded.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def half_cohort(stacked, sizes):
    from portbench.reference import cnn

    n = max(1, sizes.shape[0] // 2)
    return cnn.fedavg([{k: _head(v, n) for k, v in layer.items()}
                       for layer in stacked], sizes[:n])


def _head(v, n):
    return {k: _head(t, n) for k, t in v.items()} if isinstance(v, dict) \
        else v[:n]


def altered(launches, num_devices):
    """The launches with one device of the middle round swapped for the
    lowest-numbered device outside its cohort."""
    out = [(j, r, ids.copy()) for j, r, ids in launches]
    j, r, ids = out[len(out) // 2]
    outside = sorted(set(range(num_devices)) - set(ids.tolist()))
    ids[0] = outside[0]
    return out


def first_free(ctx):
    """A valid plan that no search chose: the first n_sel free devices."""
    plan = np.zeros(ctx.available.shape[0], dtype=bool)
    plan[np.flatnonzero(ctx.available)[:ctx.n_sel]] = True
    return plan


def engine_faults(cell, seeds, launches, records):
    """The cohort numbers where the engine's answers are altered where they
    are made: each round's time taken from the expected instead of the
    sampled times (``expected_round_time``), and its cost from the
    absolute fairness instead of its increment (``absolute_fairness``)."""
    from portbench import check
    from portbench.reference import pool as ref_pool

    tr, jobs = cell.traffic, cell.config["jobs"]
    pool = ref_pool.Pool.heterogeneous(
        tr["num_devices"], len(jobs), seeds["pool"], tr["pool"]["a_range"],
        tr["pool"]["mu_range"], tr["pool"]["data_range"])
    taus = [j["local_epochs"] for j in jobs]
    time_scale, fairness_scale = ref_pool.calibrate(pool, taus, tr["n_sel"])
    cohort = {(j, r): ids for j, r, ids in launches}
    expected, absolute = {}, {}
    for key, rec in records.items():
        ids = cohort[key]
        rt = float(pool.expected_times(key[0], taus[key[0]])[ids].max())
        expected[key] = dict(rec, round_time=rt, t_end=rec["t_start"] + rt)
        absolute[key] = dict(rec, cost=tr["alpha"] * rec["round_time"]
                             / time_scale + tr["beta"] * rec["fairness"]
                             / fairness_scale)
    return {name: check.cohort_numbers(cell.config, tr, seeds, launches, recs)
            for name, recs in (("expected_round_time", expected),
                               ("absolute_fairness", absolute))}


@contextlib.contextmanager
def dropped_mlp(layer: int):
    """The program with block ``layer``'s MLP output multiplied by 0 (its
    weights then get no gradient)."""
    from repro_torch.models import transformer

    plain = transformer.mlp_apply

    def mlp_apply(cfg, p, x):
        y = plain(cfg, p, x)
        w = p["w_down"]
        return y * 0 if w.storage_offset() // w.numel() == layer else y

    transformer.mlp_apply = mlp_apply
    try:
        yield
    finally:
        transformer.mlp_apply = plain


@contextlib.contextmanager
def _wrapped_step(wrap):
    """``make_train_step`` with its step passed through ``wrap``."""
    from repro_torch.launch import steps

    plain = steps.make_train_step

    def make_train_step(cfg, train_cfg):
        step, opt_init = plain(cfg, train_cfg)
        return wrap(step), opt_init

    steps.make_train_step = make_train_step
    try:
        yield
    finally:
        steps.make_train_step = plain


def unchanged_state():
    """A step that computes its loss and gradient norm and returns its
    parameters and optimizer state as they came."""
    def wrap(step):
        def frozen(params, opt_state, batch):
            return (params, opt_state) + (step(params, opt_state, batch)[2],)
        return frozen
    return _wrapped_step(wrap)


def half_batch():
    """A step that leaves out the second half of the batch's rows and takes
    its mean over the rest: the first half, each row twice (the batch keeps
    its shape, so that it still splits into the microbatches)."""
    def wrap(step):
        def half(params, opt_state, batch):
            return step(params, opt_state, {
                k: t[:max(1, t.shape[0] // 2)].repeat_interleave(
                    2, dim=0)[:t.shape[0]] for k, t in batch.items()})
        return half
    return _wrapped_step(wrap)


#: The lm_train faults planted in the program: name -> context manager
#: (given the model block).
LM_FAULTS = {
    "dropped_mlp": lambda model: dropped_mlp(model["num_layers"] // 2),
    "half_batch": lambda model: half_batch(),
    "unchanged_state": lambda model: unchanged_state(),
}
LM_CONTROL = "float8_e4m3fn"   # the reference in the program's place


def lm_program(cell, arch, seed: int, device: str):
    """The program's readings of one seed, its parameters before the
    checked steps after the first, and its state before the check step
    (on the host), its own state freed."""
    import torch

    from portbench import lm_harness as lm

    prog = lm.Program(cell, arch, seed, device)
    side, points = lm.warm_up(prog)
    host = lm.check_step(prog, side)
    del prog
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return side, points, host


def lm_line(cell, seed: int, device: str, controls: bool,
            faults=tuple(LM_FAULTS)) -> dict:
    """One seed's numbers of an lm_train cell: the program against the
    float32 reference, and on a control seed the reference in float8 in
    the program's place and each fault planted in the program (against the
    reference at the faulty program's own parameters)."""
    from portbench import lm_harness as lm

    t = time.perf_counter()
    arch = lm.reference(cell)
    side, points, host = lm_program(cell, arch, seed, device)
    start = lm.own_start(arch, cell, seed, device)
    ref = lm.follow(arch, cell, seed, points, host, device, start=start)
    line = {"workload": cell.name, "seed": seed,
            "program": lm.numbers(side, ref),
            "losses": {"program": side.losses, "reference": ref.losses},
            "grad_norms": {"program": side.grad_norms + [
                side.window_grad_norm], "reference": ref.grad_norms + [
                ref.window_grad_norm]}}
    if controls:
        other = lm.follow(arch, cell, seed, points, host, device, LM_CONTROL)
        line[LM_CONTROL] = lm.numbers(other, ref)
        del other
    del points, host
    if controls:
        for name in faults:
            with LM_FAULTS[name](cell.config["model"]):
                bad, bad_points, bad_host = lm_program(cell, arch, seed,
                                                       device)
            own = lm.follow(arch, cell, seed, bad_points, bad_host, device,
                            start=start)
            line[name] = lm.numbers(bad, own)
            del bad_points, bad_host
    line["seconds"] = time.perf_counter() - t
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    ap.add_argument("--skip-warmup-sides", action="store_true")
    args = ap.parse_args(argv)
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    from portbench import check, guard, harness, manifest

    cell = manifest.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    out = open(args.out, "a") if args.out else None
    if manifest.kind(cell.config) == "lm_train":
        for seed in seeds:
            line = lm_line(cell, seed, args.device, seed in controls)
            guard.check("after the readings")
            text = json.dumps(line)
            print(text, flush=True)
            if out:
                out.write(text + "\n")
                out.flush()
        return 0
    for seed in seeds:
        t = time.perf_counter()
        prep = harness.prepare(cell, seed, args.device)
        harness.warm_up(prep, int(cell.traffic["check_rounds"]))
        harness.keep_a_round_of_each_job(prep)
        prep.probe.check_flushed(prep.engine.records)
        launches = list(prep.probe.launches)
        records = harness.records_by_round(prep.engine.records)
        window = harness.window_rounds(prep.probe, launches, records)
        snapshots, sub = prep.probe.snapshots, prep.seeds
        faulted = None
        if seed in controls:
            prep.engine.scheduler.schedule = first_free
            k = len(launches) + len(prep.engine.jobs)
            harness.step_until(prep.engine,
                               lambda: len(prep.probe.launches) >= k)
            faulted = (list(prep.probe.launches),
                       harness.records_by_round(prep.engine.records))
        del prep
        gc.collect()
        if args.device == "cuda":
            torch.cuda.empty_cache()
        line = {"workload": cell.name, "seed": seed}
        line["program"] = check.cohort_numbers(cell.config, cell.traffic,
                                               sub, launches, records)
        sides = {}
        if seed in controls:
            sides = {"tf32": ("tf32", check.cnn.fedavg)}
            if not args.skip_warmup_sides:
                sides["half_cohort"] = ("float32", half_cohort)
            line["altered_cohort"] = check.cohort_numbers(
                cell.config, cell.traffic, sub,
                altered(launches, cell.traffic["num_devices"]), records)
            line.update(engine_faults(cell, sub, launches, records))
            line["first_free"] = check.cohort_numbers(
                cell.config, cell.traffic, sub, *faulted)
        per_job = {}
        judged = harness.judge_training(
            cell, sub, launches, records, snapshots, args.device, sides,
            per_job, window, warmup_sides=not args.skip_warmup_sides)
        line["program"].update(judged.pop("program"))
        for name, numbers in judged.items():
            line.setdefault(name, {}).update(numbers)
        line["per_job"] = per_job
        line["losses"] = {m: [records[(m, r)]["loss"] for r in range(4)
                              if (m, r) in records]
                          for m in range(len(cell.config["jobs"]))}
        line["seconds"] = time.perf_counter() - t
        guard.check("after the readings")
        text = json.dumps(line)
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
