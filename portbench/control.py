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
"""

from __future__ import annotations

import argparse
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
