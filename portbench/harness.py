"""One run of one cell: set-up, the measured window, the traced reading,
and the comparison with the plain reference.

Set-up builds the cell's ``ExperimentSpec`` (the data's and the initial
weights' seeds drawn from ``--seed``), wraps the engine's runtime in the
probe, launches every job and steps ``MultiJobEngine.advance_until`` until
each job has trained the traffic's ``check_rounds`` rounds (the warm-up,
whose rounds the reference follows). The window then steps the same engine on until the first round
that completes after ``--seconds``; the device is synchronised at both
ends. The rate is the samples trained in the window's first ``--seconds``
over that time: whole flushes (the runtime trains every announced round at
the first demand) by the end of their work in the device's stream, and the
flush running at that instant by its elapsed share (one flush is up to a
tenth of a window, and its work per second differs 12-fold between jobs).
Through the window the probe keeps each job's parameters before and after
its rounds, so that the check can retrain each job's last window round.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import subprocess
import time
from typing import Dict, List, Optional

import numpy as np

from portbench import check, flops, guard, manifest
from portbench.probe import JobGeometry, RuntimeProbe, to_host
from portbench.reference import data as ref_data

#: NVIDIA H100 SXM, float32 outside the tensor cores (data sheet, 700 W).
PEAK_F32_FLOPS = 67e12
UNREACHABLE_TARGET = 2.0      # accuracy never reaches it: no job retires
MAX_ROUNDS = 10 ** 9
STEPS_PER_SCALE = 16          # advance_until steps per calibrated round time
MAX_DRAWS = 1000              # data-seed draws tried for the nominal sizes
NUMBERS = check.NUMBERS       # the numbers a limits file may hold


class Failed(RuntimeError):
    """The run cannot give a result (no card, a forbidden import, ...)."""


def _steps(cell: manifest.Cell, data_seed: int) -> List[int]:
    """Each job's batches an epoch under the labels ``data_seed`` draws."""
    cfg, tr = cell.config, cell.traffic
    out = []
    for m, j in enumerate(cfg["jobs"]):
        y = ref_data.labels(cfg["samples_per_job"], j["num_classes"],
                            data_seed + m)
        width = ref_data.partition_width(y, tr["classes_per_device"],
                                         tr["parts_per_class"])
        out.append(ref_data.split_batches(width, j["batch_size"])[0])
    return out


def _draw(seed: int, k: int) -> int:
    return int(np.random.SeedSequence([int(seed), k]).generate_state(1)[0])


def sub_seeds(seed: int, cell: manifest.Cell) -> Dict[str, int]:
    """The run's seeds. The data's and the initial weights' are drawn from
    ``--seed``; the fleet's, the scheduler's and the engine's come from the
    traffic file, so that every run schedules the same rounds. The data
    seed is the first draw whose labels give every job as many batches an
    epoch as the cell's nominal draw does: a partition's width follows its
    rarest class, so a draw could otherwise change the work."""
    tr = cell.traffic
    nominal = _steps(cell, _draw(0, 0))
    for k in range(MAX_DRAWS):
        data = _draw(seed, k)
        if _steps(cell, data) == nominal:
            break
    else:
        raise Failed(f"no data seed of {seed} gives the nominal batches")
    init = int(np.random.SeedSequence(int(seed)).generate_state(2)[1])
    return dict(data=data, init=init, pool=tr["pool_seed"],
                scheduler=tr["scheduler_seed"], engine=tr["engine_seed"])


def geometry(cell: manifest.Cell, seeds: Dict[str, int]) -> List[JobGeometry]:
    """Each job's work per device and round, from the configuration and
    the labels the seed gives."""
    cfg, tr = cell.config, cell.traffic
    out = []
    for m, j in enumerate(cfg["jobs"]):
        y = ref_data.labels(cfg["samples_per_job"], j["num_classes"],
                            seeds["data"] + m)
        width = ref_data.partition_width(y, tr["classes_per_device"],
                                         tr["parts_per_class"])
        steps, batch = ref_data.split_batches(width, j["batch_size"])
        spec = j["cnn_spec"]
        out.append(JobGeometry(
            width=width, steps=steps, batch=batch, epochs=j["local_epochs"],
            train_flops=flops.train_flops(spec, j["input_shape"],
                                          j["num_classes"]),
            eval_flops=flops.forward_flops(spec, j["input_shape"],
                                           j["num_classes"]),
            eval_samples=cfg["eval_samples"]))
    return out


def build_spec(cell: manifest.Cell, seeds: Dict[str, int]):
    """The cell as the program's ``ExperimentSpec``; refuses a model whose
    registered shape differs from the configuration file's."""
    from repro_torch.config.registry import get_arch
    from repro_torch.experiment.spec import (CostSpec, ExperimentSpec,
                                             FleetSpec, JobSpec, PoolSpec,
                                             TrainSpec)

    cfg, tr = cell.config, cell.traffic
    for j in cfg["jobs"]:
        arch = get_arch(j["model"])
        if (tuple(map(tuple, j["cnn_spec"])) != tuple(arch.cnn_spec)
                or tuple(j["input_shape"]) != tuple(arch.input_shape)
                or j["num_classes"] != arch.num_classes):
            raise Failed(f"{j['model']}: the program's shape differs from "
                         f"configs/{cfg['name']}.json")
    jobs = tuple(JobSpec(name=j["name"], model=j["model"],
                         target_metric=UNREACHABLE_TARGET,
                         max_rounds=MAX_ROUNDS,
                         local_epochs=j["local_epochs"],
                         batch_size=j["batch_size"], lr=j["lr"])
                 for j in cfg["jobs"])
    p = tr["pool"]
    kwargs = {}
    if tr.get("bods"):
        b = tr["bods"]
        kwargs = dict(num_candidates=int(b["candidates"]),
                      init_points=int(b["init_points"]),
                      gp_noise=float(b["gp_noise"]))
    return ExperimentSpec(
        jobs=jobs,
        pool=PoolSpec(num_devices=tr["num_devices"], seed=seeds["pool"],
                      a_range=tuple(p["a_range"]),
                      mu_range=tuple(p["mu_range"]),
                      data_range=tuple(p["data_range"])),
        cost=CostSpec(alpha=tr["alpha"], beta=tr["beta"]),
        fleet=FleetSpec(candidates=tr.get("candidates"),
                        scoring_backend=tr["scoring_backend"],
                        search_backend=tr["search_backend"]),
        scheduler=tr["scheduler"], scheduler_seed=seeds["scheduler"],
        scheduler_kwargs=kwargs, runtime="real_fl",
        runtime_kwargs=dict(
            samples_per_job=cfg["samples_per_job"],
            eval_samples=cfg["eval_samples"], noise=cfg["noise"],
            data_seed=seeds["data"], init_seed=seeds["init"],
            classes_per_device=tr["classes_per_device"],
            parts_per_class=tr["parts_per_class"]),
        train=TrainSpec(eval_every=1), non_iid=True, n_sel=tr["n_sel"],
        engine_seed=seeds["engine"], name=cell.name)


def step_until(engine, stop, on_round=None) -> None:
    """Drive ``advance_until`` in steps of simulated time until ``stop()``."""
    dt = engine.cost_model.time_scale / STEPS_PER_SCALE
    t = engine.clock
    while not stop():
        if all(js.done for js in engine.jobs):
            raise Failed("every job finished: nothing left to drive")
        t += dt
        engine.advance_until(t, on_round=on_round)


def _marker(cuda: bool):
    """A stamp of now in the device's stream (a CUDA event), or on the
    host's clock where the work runs on the host."""
    import torch

    def mark():
        if not cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return mark


def _seconds_since(start, mark) -> float:
    if isinstance(start, float):
        return mark - start
    return start.elapsed_time(mark) / 1e3


def samples_in(ends: List[float], samples: List[int], seconds: float
               ) -> float:
    """The samples trained in the first ``seconds`` of the window: every
    flush whose work ended by then, and of the flush running at that
    instant the share of its samples that its elapsed share gives (its
    span runs from the previous flush's end)."""
    done, prev = 0.0, 0.0
    for end, n in zip(ends, samples):
        if end <= seconds:
            done += n
        else:
            done += n * (seconds - prev) / (end - prev)
            break
        prev = end
    return done


@dataclasses.dataclass
class RunData:
    """What the per-layer readers read (``portbench/metrics/*.py``)."""

    window_s: float
    rounds: int                 # rounds recorded in the window
    count: object               # the probe's WindowCount (flushed rounds)
    window_peak_bytes: int
    device_ops: list = None     # tracing.DeviceOp, sorted
    busy_s: float = None
    spans: list = None          # tracing.Span in the profiler's clock
    peak_flops: float = PEAK_F32_FLOPS


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def records_by_round(records) -> Dict:
    return {(r.job, r.round_idx): dict(
        t_start=r.t_start, t_end=r.t_end, round_time=r.round_time,
        cost=r.cost, fairness=r.fairness, est_cost=r.est_cost,
        loss=r.loss, accuracy=r.accuracy) for r in records}


@dataclasses.dataclass
class Prepared:
    """A built experiment with its probe, launched and not yet warmed up."""

    seeds: Dict[str, int]
    exp: object
    engine: object
    probe: RuntimeProbe


def prepare(cell: manifest.Cell, seed: int, device: str) -> Prepared:
    """Build the cell's experiment on ``device``, wrap its runtime in the
    probe, and launch every job's first round."""
    import torch

    if device == "cuda":
        if not torch.cuda.is_available():
            raise Failed("no CUDA device")
        if torch.cuda.device_count() < cell.chips:
            raise Failed(f"{torch.cuda.device_count()} CUDA devices, the "
                         f"cell asks for {cell.chips}")
    if cell.config.get("tf32") is False:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    seeds = sub_seeds(seed, cell)
    geo = geometry(cell, seeds)
    spec = build_spec(cell, seeds)
    guard.check("after the program's import")
    exp = spec.build(device=device)
    engine = exp.engine
    probe = RuntimeProbe(engine.runtime, geo)
    engine.runtime = probe
    prep = Prepared(seeds, exp, engine, probe)
    for m in range(len(engine.jobs)):
        engine.launch_job(m, 0.0)
    return prep


def warm_up(prep: Prepared, rounds: int) -> None:
    """Drive the engine until every job has trained ``rounds`` rounds,
    copying each flush's trained parameters to the host."""
    prep.probe.snapshotting = True
    step_until(prep.engine, lambda: min(prep.probe.trained) >= rounds)
    prep.probe.snapshotting = False


def window_rounds(probe: RuntimeProbe, launches, records: Dict) -> Dict:
    """Each job's last round trained in the window that has a record:
    job -> (round, cohort, parameters before it and after it on the host,
    its held-out loss)."""
    cohort = {(j, r): ids for j, r, ids in launches}
    out = {}
    for job, pairs in probe.pairs.items():
        done = [r for r in pairs if (job, r) in records]
        if done:
            r = max(done)
            before, after = pairs[r]
            out[job] = (r, cohort[(job, r)], to_host(before),
                        to_host(after), records[(job, r)]["loss"])
    return out


def keep_a_round_of_each_job(prep: Prepared) -> None:
    """Drive the engine on, where need be, until every job has recorded a
    round whose parameters before and after the probe kept."""
    engine, probe = prep.engine, prep.probe

    def kept():
        done = {(r.job, r.round_idx) for r in engine.records}
        return all(any((m, r) in done for r in probe.pairs[m])
                   for m in range(len(engine.jobs)))
    probe.keeping_pairs = True
    step_until(engine, kept)
    probe.keeping_pairs = False


def judge_training(cell: manifest.Cell, seeds: Dict[str, int], launches,
                   records: Dict, snapshots: Dict, device: str,
                   sides: Optional[Dict] = None,
                   per_job: Optional[Dict] = None,
                   window: Optional[Dict] = None,
                   warmup_sides: bool = True) -> Dict[str, Dict]:
    """The training numbers of the program (``"program"``) and of each of
    ``sides`` (name -> (matmul precision, aggregation) of a reference put
    in the program's place), each against the float32 reference: the worst
    over the jobs (each job's in ``per_job``, where given). ``window``
    (``window_rounds``) adds the window round's numbers; a job with none
    reads inf there. Without ``warmup_sides`` the sides train the window
    round alone."""
    sides = sides or {}
    per_side: Dict[str, list] = {"program": [], **{k: [] for k in sides}}
    for m, job in enumerate(cell.config["jobs"]):
        inputs = check.job_inputs(cell.config, cell.traffic, m, seeds,
                                  device)
        prog = check.program_trajectory(snapshots[m], records, m)
        cohorts = [ids for j, r, ids in launches if j == m][:prog.rounds]
        ref = check.follow(cell.config, m, inputs, cohorts,
                           check.cnn.Net(job["cnn_spec"]))
        numbers = {"program": check.training_numbers(prog, ref, inputs[-1])}
        for name, (precision, aggregate) in sides.items():
            numbers[name] = {}
            if warmup_sides:
                other = check.follow(cell.config, m, inputs, cohorts,
                                     check.cnn.Net(job["cnn_spec"],
                                                   precision), aggregate)
                numbers[name] = check.training_numbers(other, ref,
                                                       inputs[-1])
        if window is not None:
            missing = dict(window_loss_gap=math.inf,
                           window_update_gap=math.inf)
            for d in numbers.values():
                d.update(missing)
        if window is not None and m in window:
            _, ids, before, after, loss = window[m]
            net = check.cnn.Net(job["cnn_spec"])
            ref_after, ref_loss = check.one_round(cell.config, m, inputs, ids,
                                                  before, net)
            numbers["program"].update(check.round_numbers(
                before, after, loss, ref_after, ref_loss))
            for name, (precision, aggregate) in sides.items():
                net = check.cnn.Net(job["cnn_spec"], precision)
                o_after, o_loss = check.one_round(cell.config, m, inputs, ids,
                                                  before, net, aggregate)
                numbers[name].update(check.round_numbers(
                    before, o_after, o_loss, ref_after, ref_loss))
        for name, d in numbers.items():
            per_side[name].append(d)
        del inputs
    if per_job is not None:
        per_job.update(per_side)
    return {k: check.worst(v) for k, v in per_side.items()}


def run(cell: manifest.Cell, seed: int, seconds: float, trace: bool,
        process_start: float, device: str = "cuda") -> dict:
    """One run; returns the result object that ``run.py`` prints."""
    import torch

    phases = {"start_s": time.time() - process_start}
    t = time.perf_counter()
    prep = prepare(cell, seed, device)
    engine, probe = prep.engine, prep.probe
    phases["build_s"] = time.perf_counter() - t
    t = time.perf_counter()
    warm_up(prep, int(cell.traffic["check_rounds"]))
    cuda = device == "cuda"
    setup_peak = 0
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    n_warm = len(engine.records)
    phases["warmup_s"] = time.perf_counter() - t

    prof = tracer = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        from repro_torch.monitoring import trace as ptrace

        tracer = ptrace.get_tracer()
        tracer.clear()
        if cuda:
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.__enter__()
        ptrace.enable()
    closed = [False]
    t0 = time.perf_counter()
    offset_ns = time.time_ns() - time.perf_counter_ns()
    probe.mark = _marker(cuda)
    start = probe.mark()
    setup_s = time.time() - process_start
    deadline = t0 + seconds

    def close_after_deadline(rec):
        if time.perf_counter() >= deadline:
            closed[0] = True

    probe.counting = probe.keeping_pairs = True
    step_until(engine, lambda: closed[0], close_after_deadline)
    if cuda:
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    probe.counting = probe.keeping_pairs = False
    window_s = t1 - t0
    ends = [_seconds_since(start, m) for m, _ in probe.count.flushes]
    in_window = samples_in(ends, [n for _, n in probe.count.flushes],
                           seconds)
    window_records = engine.records[n_warm:]
    run_data = RunData(
        window_s=window_s, rounds=len(window_records), count=probe.count,
        window_peak_bytes=(torch.cuda.max_memory_allocated() if cuda else 0))
    if trace:
        from repro_torch.monitoring import trace as ptrace

        from portbench import tracing

        ptrace.disable()
        ops = []
        if prof is not None:
            prof.__exit__(None, None, None)
            ops = tracing.device_ops(prof)
            del prof
        run_data.device_ops = ops
        run_data.spans = tracing.program_spans(tracer.events(), offset_ns)
        tracer.clear()
        run_data.busy_s = tracing.busy_seconds(tracing.busy_intervals(ops))
    guard.check("after the window")

    # Where a job recorded no round in the window (only at sizes far
    # below a cell's), its first round after the window stands in.
    keep_a_round_of_each_job(prep)
    try:
        probe.check_flushed(engine.records)
    except RuntimeError as e:
        raise Failed(str(e))
    seeds, snapshots = prep.seeds, probe.snapshots
    launches = list(probe.launches)
    records = records_by_round(engine.records)
    window = window_rounds(probe, launches, records)
    failed = sum(1 for r in window_records
                 if r.degraded or not math.isfinite(r.loss))
    memory_peak = max(setup_peak, run_data.window_peak_bytes)
    del prep, engine, probe
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t = time.perf_counter()
    numbers = check.cohort_numbers(cell.config, cell.traffic, seeds,
                                   launches, records)
    numbers.update(judge_training(cell, seeds, launches, records, snapshots,
                                  device, window=window)["program"])
    correct = check.verdict(numbers, cell.limits)
    phases["reference_s"] = time.perf_counter() - t

    out = result(cell, correct=correct, attempted=len(window_records),
                 failed=failed, run_data=run_data, memory_peak=memory_peak,
                 values={"train_samples_per_s": in_window / seconds,
                         "setup_s": setup_s},
                 trace=trace, cuda=cuda, lo_ns=int(t0 * 1e9) + offset_ns)
    out["window"] = {"seconds": window_s, "flush_ends": ends,
                     "samples_in_seconds": in_window,
                     "rounds_flushed": run_data.count.rounds,
                     "samples": run_data.count.samples,
                     "sgd_steps": run_data.count.sgd_steps,
                     "flops": run_data.count.flops,
                     "rounds_recorded": len(window_records),
                     "warmup_rounds": n_warm,
                     "nonfinite_rounds": [
                         sum(1 for (j, _), r in records.items()
                             if j == m and not math.isfinite(r["loss"]))
                         for m in range(len(cell.config["jobs"]))],
                     "trained_before": [max(snapshots[m])
                                        for m in sorted(snapshots)],
                     "checked_rounds": [window[m][0] for m in sorted(window)],
                     "phases": phases}
    out["checks"] = checks(numbers, cell.limits)
    return out


def result(cell: manifest.Cell, *, correct: bool, attempted: int,
           failed: int, run_data, memory_peak: int, values: Dict[str, float],
           trace: bool, cuda: bool, lo_ns: int,
           outside: str = "engine_loop") -> dict:
    """The result object's head, the same for every kind: ``correct``,
    ``attempted``, ``failed``, ``metrics`` (``values`` of the cell's
    end-to-end metrics, or with ``trace`` its per-layer readers' readings
    of ``run_data``), ``device``, with ``trace`` ``breakdown`` (the device's
    idle gaps from ``lo_ns`` over ``run_data.window_s`` by the host span
    open, ``outside`` where none was), and ``card``; the runner adds
    ``window`` and last ``checks``."""
    import torch

    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = manifest.reader(m["name"], cell.base)(run_data)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
    out = {"correct": bool(correct), "attempted": attempted,
           "failed": failed, "metrics": metrics, "device": dev}
    if trace:
        from portbench import tracing

        dev["busy_s"] = run_data.busy_s
        dev["window_s"] = run_data.window_s
        gaps = tracing.idle_by_host(
            tracing.busy_intervals(run_data.device_ops), run_data.spans,
            lo_ns, lo_ns + int(run_data.window_s * 1e9), outside)
        out["breakdown"] = {
            "device_ops": tracing.top_ops(run_data.device_ops),
            "idle_gaps": sorted(([k, v] for k, v in gaps.items()),
                                key=lambda kv: -kv[1])[:10]}
    out["card"] = power_limit() if cuda else None
    return out


def checks(numbers: Dict[str, float], limits: Dict[str, float]) -> dict:
    """Each number of the limits file beside its limit (nan where the run
    read none)."""
    return {k: {"value": numbers.get(k, float("nan")), "limit": v}
            for k, v in limits.items()}


