"""Scheduler-service CLI.

  python -m repro_torch.serve --preset online-smoke
  python -m repro_torch.serve --preset online-smoke --device cpu
  python -m repro_torch.serve --preset online-smoke --rescore full --out report.json
  python -m repro_torch.serve --spec spec.json --save-trace trace.json
  python -m repro_torch.serve --preset online-smoke --trace trace.json --verbose
  python -m repro_torch.serve --preset fault-injection \\
      --checkpoint-dir ckpt/ --checkpoint-every 5
  python -m repro_torch.serve --resume ckpt/ --out report.json

``--preset``/``--arg``/``--set`` follow the experiment CLI's conventions
(``--arg k=v`` feeds the preset factory, ``--set k=v`` overrides spec
fields, including nested dicts: ``--set 'arrivals={"horizon": 40000}'``).
``--save-trace`` writes the generated traffic stream as JSON;
``--trace`` replays one (bit-identical traffic across service configs —
how the incremental-vs-full benchmark holds traffic fixed).

Crash consistency: ``--checkpoint-dir``/``--checkpoint-every N`` atomically
persist the FULL service state every N traffic events; ``--resume DIR``
restarts from the newest committed step (the spec rides in the checkpoint,
so no ``--preset``/``--spec`` is needed) and continues BIT-IDENTICALLY.
``--crash-after N`` hard-kills the process (``os._exit(137)``, no cleanup —
the ``kill -9`` equivalent) after the Nth event; ``--records-out`` dumps
the engine's per-round records for trajectory comparison. ``--device``
(default ``cuda``) is where the tensor work runs; a resumed run takes it
from the command line, never from the checkpoint.
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.experiment.cli import _parse_kv
from repro_torch.experiment.presets import get_preset
from repro_torch.experiment.spec import ExperimentSpec, _record_to_dict
from repro_torch.serve.service import RESCORE_MODES, SchedulerService
from repro_torch.serve.traffic import load_trace, save_trace, trace_from_spec


def _print_report(service: SchedulerService) -> None:
    r = service.last_report
    lat = r.decision_latency
    print(f"\n[{service.spec.name}] scheduler={service.spec.scheduler} "
          f"rescore={service.rescore_mode}")
    print(f"  traffic: {r.arrivals} arrivals, {r.departures} departures, "
          f"{r.readmissions} readmissions, {r.churn_events} churn events, "
          f"{r.rejections} queued")
    print(f"  rounds:  {r.rounds_completed} completed "
          f"({r.rounds_per_sec:.1f}/s wall), tenant fairness "
          f"(Jain) {r.tenant_fairness:.3f}")
    print(f"  latency: p50={lat['p50_s'] * 1e3:.2f}ms "
          f"p99={lat['p99_s'] * 1e3:.2f}ms over {lat['count']} decisions; "
          f"queue depth max={r.queue_depth_max}")
    res = r.resilience
    if res:
        rungs = res.get("rung_counts", {})
        hist = " ".join(f"{k}={v}" for k, v in rungs.items() if v)
        print(f"  slo:     rungs[{hist or 'none'}] "
              f"shed={res['shed_arrivals']} deferred={res['deferrals']} "
              f"breaker_trips={res['breaker_trips']} "
              f"recoveries={res['recoveries']} "
              f"deadline_misses={res.get('deadline_misses', 0)}")
        for rung, st in sorted(res.get("rung_latency_ms", {}).items()):
            print(f"    rung {rung:12s} n={st['count']:4d} "
                  f"p50={st['p50']:.2f}ms p99={st['p99']:.2f}ms")
    for name, t in sorted(service.metrics.tenants.items()):
        print(f"    {name:12s} rounds={t.rounds:4d} "
              f"admissions={t.admissions} "
              f"mean_cost={t.total_cost / t.rounds if t.rounds else 0.0:.3f} "
              f"best_acc={t.best_accuracy:.3f}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serve", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    src = ap.add_mutually_exclusive_group()
    src.add_argument("--preset", help="preset name (e.g. online-smoke)")
    src.add_argument("--spec", help="path to an ExperimentSpec JSON file")
    src.add_argument("--resume", metavar="DIR",
                     help="resume from the newest committed checkpoint in "
                          "DIR (the spec rides in the checkpoint)")
    ap.add_argument("--arg", action="append", metavar="K=V",
                    help="preset factory argument")
    ap.add_argument("--set", action="append", metavar="K=V",
                    help="override a spec field (nested dicts merge)")
    ap.add_argument("--rescore", choices=RESCORE_MODES,
                    default="incremental")
    ap.add_argument("--trace", help="replay this traffic trace JSON")
    ap.add_argument("--save-trace", help="write the traffic trace here")
    ap.add_argument("--out", help="write the ServiceReport JSON here")
    ap.add_argument("--checkpoint-dir",
                    help="atomically checkpoint the service state here")
    ap.add_argument("--checkpoint-every", type=int, default=5,
                    metavar="N", help="checkpoint every N traffic events "
                    "(default 5; needs --checkpoint-dir)")
    ap.add_argument("--crash-after", type=int, metavar="N",
                    help="hard-kill the process (os._exit 137) after the "
                         "Nth traffic event — chaos testing")
    ap.add_argument("--records-out",
                    help="dump the engine's per-round records JSON here "
                         "(trajectory comparison across crash/resume)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the tensor work (default cuda; "
                         "cpu on a machine without a card)")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)
    if not (args.preset or args.spec or args.resume):
        ap.error("one of --preset, --spec, --resume is required")

    if args.resume:
        if args.set or args.arg or args.trace:
            ap.error("--resume replays the checkpointed spec and trace; "
                     "--set/--arg/--trace cannot be combined with it")
        service = SchedulerService.resume(args.resume, verbose=args.verbose,
                                          device=args.device)
        trace = None   # run() continues the restored trace
    else:
        if args.preset:
            spec = get_preset(args.preset, **_parse_kv(args.arg))
        else:
            spec = ExperimentSpec.load(args.spec)
        if args.set:
            spec = spec.replace(**_parse_kv(args.set))
        if spec.arrivals is None:
            raise SystemExit("spec has no arrivals axis — use an online "
                             "preset or --set 'arrivals={...}'")
        service = SchedulerService(spec, rescore_mode=args.rescore,
                                   verbose=args.verbose,
                                   checkpoint_dir=args.checkpoint_dir,
                                   checkpoint_every=args.checkpoint_every,
                                   device=args.device)
        trace = (load_trace(args.trace) if args.trace
                 else trace_from_spec(spec.arrivals, len(service.templates),
                                      service.engine.pool.num_devices))
        if args.save_trace:
            save_trace(trace, args.save_trace)
            print(f"trace -> {args.save_trace} ({len(trace)} events)")

    if args.crash_after is not None:
        # The hard-kill path: run until the Nth event boundary, then exit
        # WITHOUT cleanup (no atexit, no flush) — indistinguishable from
        # kill -9 as far as the checkpoint directory is concerned.
        import os

        from repro_torch.serve.service import SimulatedCrash

        service.crash_after = args.crash_after
        try:
            service.run(trace)
        except SimulatedCrash:
            os._exit(137)
        raise SystemExit(
            f"--crash-after {args.crash_after}: trace ended after "
            f"{service._next_event} events without reaching the crash point")

    report = service.run(trace)
    _print_report(service)
    if args.out:
        report.save(args.out)
        print(f"report -> {args.out}")
    if args.records_out:
        with open(args.records_out, "w") as f:
            json.dump([_record_to_dict(r) for r in service.engine.records],
                      f, indent=2)
            f.write("\n")
        print(f"records -> {args.records_out}")


if __name__ == "__main__":
    main(sys.argv[1:])
