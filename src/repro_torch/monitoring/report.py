"""Run reports from traces + metrics JSONL.

``python -m repro_torch.monitoring report trace.json`` answers "where did the
wall-clock go": a per-phase breakdown table (count, total, p50/p99 per span
kind), span coverage of engine wall-clock, rounds per second, and (given
``--metrics``) a per-job cost/fairness summary. ``--diff other_trace.json``
prints per-phase p50 deltas between two runs.

All pure functions here (``phase_stats``, ``coverage``, ``diff_phases``,
``summarize``) are importable for programmatic use; the CLI lives in
``repro_torch.monitoring.__main__``.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.monitoring.trace import DEVICE_PID

# Disjoint per-round engine phases (see core/multijob.py): their summed
# duration over an ``engine_run`` span is the covered wall-clock.
ENGINE_PHASES = ("ctx_build", "schedule", "dispatch", "aggregate", "record")


# ---- loading ----

def load_trace(path: str) -> List[dict]:
    """Chrome trace-event JSON -> event list (accepts both the
    ``{"traceEvents": [...]}`` object form and a bare array)."""
    with open(path) as f:
        d = json.load(f)
    return d["traceEvents"] if isinstance(d, dict) else d


def load_metrics(path: str) -> List[dict]:
    out = []
    with open(path) as f:
        for line in f:
            if line.strip():
                out.append(json.loads(line))
    return out


# ---- trace statistics ----

def phase_stats(events: List[dict]) -> Dict[str, dict]:
    """Per span-kind wall-clock stats from complete (``ph == "X"``) events;
    a device range (on the tracer's device track) counts as its own kind,
    ``"<name> (device)"``."""
    durs: Dict[str, list] = {}
    for ev in events:
        if ev.get("ph") == "X":
            name = ev["name"] + (" (device)" if ev.get("pid") == DEVICE_PID
                                 else "")
            durs.setdefault(name, []).append(float(ev.get("dur", 0.0)))
    out = {}
    for name, d in sorted(durs.items()):
        a = np.asarray(d) / 1e3  # us -> ms
        out[name] = {
            "count": int(a.size),
            "total_ms": float(a.sum()),
            "mean_ms": float(a.mean()),
            "p50_ms": float(np.percentile(a, 50)),
            "p99_ms": float(np.percentile(a, 99)),
        }
    return out


def coverage(stats: Dict[str, dict],
             phases: Tuple[str, ...] = ENGINE_PHASES,
             root: str = "engine_run") -> Optional[float]:
    """Fraction of the root span's wall-clock covered by the (disjoint)
    engine phase spans; None when the trace has no root span."""
    if root not in stats or stats[root]["total_ms"] <= 0.0:
        return None
    covered = sum(stats[p]["total_ms"] for p in phases if p in stats)
    return covered / stats[root]["total_ms"]


def rounds_per_sec(stats: Dict[str, dict],
                   root: str = "engine_run") -> Optional[float]:
    """Completed rounds (one ``record`` span each) per second of engine
    wall-clock."""
    if root not in stats or "record" not in stats:
        return None
    wall_s = stats[root]["total_ms"] / 1e3
    return stats["record"]["count"] / wall_s if wall_s > 0 else None


def per_job_summary(metrics: List[dict]) -> Dict[int, dict]:
    """Per-job cost/fairness rollup from a round-metrics JSONL."""
    by_job: Dict[int, list] = {}
    for m in metrics:
        if "job" in m:
            by_job.setdefault(int(m["job"]), []).append(m)
    out = {}
    for job, rows in sorted(by_job.items()):
        cost = np.asarray([r.get("cost", np.nan) for r in rows], dtype=float)
        fair = np.asarray([r.get("fairness", np.nan) for r in rows],
                          dtype=float)
        out[job] = {
            "rounds": len(rows),
            "mean_cost": float(np.nanmean(cost)) if cost.size else 0.0,
            "total_cost": float(np.nansum(cost)),
            "mean_fairness": float(np.nanmean(fair)) if fair.size else 0.0,
            "final_accuracy": float(rows[-1].get("accuracy", 0.0)),
            "degraded_rounds": sum(1 for r in rows if r.get("degraded")),
        }
    return out


def slo_summary(metrics: List[dict]) -> Optional[dict]:
    """Degradation-ladder rollup from round-metrics JSONL rows carrying the
    SLO axis' ``rung``/``decision_ms`` fields (see ``repro_torch.serve.resilience``).
    None when no row has a rung — the run had no governor attached."""
    rows = [m for m in metrics if m.get("rung") is not None]
    if not rows:
        return None
    out: Dict[str, dict] = {}
    for rung in sorted({str(m["rung"]) for m in rows}):
        ms = np.asarray([float(m["decision_ms"]) for m in rows
                         if str(m["rung"]) == rung
                         and m.get("decision_ms") is not None])
        entry = {"count": sum(1 for m in rows if str(m["rung"]) == rung)}
        if ms.size:
            entry["p50_ms"] = float(np.percentile(ms, 50))
            entry["p99_ms"] = float(np.percentile(ms, 99))
        out[rung] = entry
    degraded = sum(1 for m in rows if str(m["rung"]) != "full")
    return {"rungs": out, "decisions": len(rows),
            "degraded_decisions": degraded}


# ---- rendering ----

def format_table(stats: Dict[str, dict], sort_by: str = "total_ms") -> str:
    lines = [f"{'phase':24s} {'count':>7s} {'total_ms':>10s} "
             f"{'mean_ms':>9s} {'p50_ms':>9s} {'p99_ms':>9s}"]
    for name, s in sorted(stats.items(), key=lambda kv: -kv[1][sort_by]):
        lines.append(f"{name:24s} {s['count']:7d} {s['total_ms']:10.2f} "
                     f"{s['mean_ms']:9.3f} {s['p50_ms']:9.3f} "
                     f"{s['p99_ms']:9.3f}")
    return "\n".join(lines)


def summarize(trace_path: str,
              metrics_path: Optional[str] = None) -> dict:
    """Everything the report prints, as one JSON-ready dict."""
    events = load_trace(trace_path)
    stats = phase_stats(events)
    out = {
        "trace": trace_path,
        "phases": stats,
        "coverage": coverage(stats),
        "rounds_per_sec": rounds_per_sec(stats),
    }
    if metrics_path:
        metrics = load_metrics(metrics_path)
        out["jobs"] = per_job_summary(metrics)
        slo = slo_summary(metrics)
        if slo is not None:
            out["slo"] = slo
    return out


# ---- run diffs ----

def diff_phases(a: Dict[str, dict], b: Dict[str, dict]) -> Dict[str, dict]:
    """Per-phase p50/total deltas of run b relative to run a (shared phases
    only). ``p50_ratio`` > 1 means b is slower."""
    out = {}
    for name in sorted(set(a) & set(b)):
        pa, pb = a[name], b[name]
        out[name] = {
            "p50_ms_a": pa["p50_ms"], "p50_ms_b": pb["p50_ms"],
            "p50_ratio": (pb["p50_ms"] / pa["p50_ms"]
                          if pa["p50_ms"] > 0 else float("inf")),
            "total_ms_a": pa["total_ms"], "total_ms_b": pb["total_ms"],
        }
    return out
