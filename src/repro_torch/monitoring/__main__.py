"""Monitoring CLI: per-phase wall-clock reports from traces.

  python -m repro_torch.monitoring report trace.json
  python -m repro_torch.monitoring report trace.json --metrics metrics.jsonl
  python -m repro_torch.monitoring report trace.json --diff other_trace.json

Generate the inputs with the spec's ``obs`` axis on any run::

  python -m repro_torch.experiment.cli preset quickstart \\
      --set obs.trace_path=trace.json --set obs.metrics_path=metrics.jsonl
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.monitoring import report as rpt


def cmd_report(args) -> int:
    events = rpt.load_trace(args.trace)
    stats = rpt.phase_stats(events)
    if not stats:
        print(f"{args.trace}: no complete ('X') span events")
        return 1
    print(f"== {args.trace} ==")
    print(rpt.format_table(stats))
    cov = rpt.coverage(stats)
    rps = rpt.rounds_per_sec(stats)
    line = []
    if cov is not None:
        line.append(f"engine span coverage {cov * 100:.1f}%")
    if rps is not None:
        line.append(f"rounds/sec={rps:.1f}")
    if line:
        print("  " + "  ".join(line))

    if args.metrics:
        metrics = rpt.load_metrics(args.metrics)
        print("\nper-job summary (metrics JSONL):")
        for job, s in rpt.per_job_summary(metrics).items():
            print(f"  job {job}: rounds={s['rounds']:4d} "
                  f"mean_cost={s['mean_cost']:.3f} "
                  f"mean_fairness={s['mean_fairness']:.3f} "
                  f"final_acc={s['final_accuracy']:.3f} "
                  f"degraded={s['degraded_rounds']}")
        slo = rpt.slo_summary(metrics)
        if slo is not None:
            print(f"\nslo ladder ({slo['decisions']} decisions, "
                  f"{slo['degraded_decisions']} degraded):")
            for rung, s in slo["rungs"].items():
                tail = (f" p50={s['p50_ms']:.2f}ms p99={s['p99_ms']:.2f}ms"
                        if "p50_ms" in s else "")
                print(f"  rung {rung:12s} n={s['count']:5d}{tail}")

    if args.diff:
        other = rpt.phase_stats(rpt.load_trace(args.diff))
        print(f"\n== diff vs {args.diff} (ratio > 1: {args.diff} slower) ==")
        print(f"{'phase':24s} {'p50_ms (this)':>14s} {'p50_ms (other)':>15s} "
              f"{'ratio':>7s}")
        for name, d in rpt.diff_phases(stats, other).items():
            print(f"{name:24s} {d['p50_ms_a']:14.3f} {d['p50_ms_b']:15.3f} "
                  f"{d['p50_ratio']:7.2f}")

    if args.json:
        out = rpt.summarize(args.trace, metrics_path=args.metrics)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2)
        print(f"\nreport JSON -> {args.json}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.monitoring", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("report", help="per-phase wall-clock breakdown of a "
                                      "trace (+ optional diff)")
    p.add_argument("trace", help="Chrome/Perfetto trace JSON "
                                 "(obs.trace_path output)")
    p.add_argument("--metrics", help="round-metrics JSONL "
                                     "(obs.metrics_path output)")
    p.add_argument("--diff", metavar="TRACE2",
                   help="second trace: print per-phase p50 ratios")
    p.add_argument("--json", metavar="OUT",
                   help="also write the full report as JSON")
    p.set_defaults(fn=cmd_report)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
