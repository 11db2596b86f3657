"""Crash-consistent scheduler-service checkpoints.

The service's full state splits the same way the engine's does (see
``MultiJobEngine.state_arrays``/``state_meta``): an ARRAY half persisted as
an atomic ``repro_torch.checkpoint`` pytree (fairness counts, in-flight round
arrays, fault-quarantine strikes, pool coefficients/occupancy, scheduler
learned state, runtime convergence state, retired tenants' warm hand-off
slices) and a JSON half riding in the manifest's ``extra`` (the spec, the
traffic trace, the engine's event heap and clock, every RNG's bit-generator
state, round records, service maps, metrics counters).

Resume contract: ``restore_service`` rebuilds the construction-time
skeleton from the spec (templates parked, dynamic jobs re-added from their
templates in id order — every per-job row then has the saved shape), loads
the newest COMMITTED step, and overwrites all mutable state. Because the
fault schedule, traffic trace, and every RNG are replayed/restored exactly,
a service killed mid-run (``kill -9`` included — saves are atomic
tmp+rename) resumes BIT-IDENTICALLY: same rounds, same plans, same metrics.

The layout is the reference's: the same tree (leaf keys, dtypes, shapes)
and the same ``extra`` keys and meanings, the spec with the reference's
scoring-backend names, so either package resumes the other's checkpoint.
Tensor leaves (RLDS and DNN params, RLDS ``OptState``) are saved from the
host and restored onto the device of the rebuilt service's own tensors.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import committed_steps, load_checkpoint
from repro_torch.experiment.spec import (BACKEND_ALIASES, _record_from_dict,
                                         _record_to_dict)
from repro_torch.serve.traffic import TrafficEvent
from repro_torch.tree import tree_map

_INFLIGHT_DTYPES = dict(
    plan=bool, survivors=int, counted=int, failed=int, dropped=int,
    corrupt=int, ctx_available=bool, ctx_counts=np.float64,
    ctx_times=np.float64)


_REFERENCE_BACKENDS = {v: k for k, v in BACKEND_ALIASES.items()}


def _spec_dict(spec) -> dict:
    """``spec.to_dict()`` with the scoring backends in the reference's
    names (``torch`` -> ``jax``, ``cuda`` -> ``pallas``), which
    ``ExperimentSpec.from_dict`` maps back on either side."""
    d = spec.to_dict()
    for holder in (d, d["fleet"]):
        b = holder.get("scoring_backend")
        holder["scoring_backend"] = _REFERENCE_BACKENDS.get(b, b)
    return d


def _runtime_state(runtime) -> dict:
    sd = getattr(runtime, "state_dict", None)
    return sd() if sd is not None else {}


def service_state(service) -> Tuple[dict, dict]:
    """(tree, extra): the array pytree and its JSON sidecar."""
    eng = service.engine
    tree = {
        "engine": eng.state_arrays(),
        "pool": eng.pool.state_dict(),
        "scheduler": eng.scheduler.state_dict(),
        "runtime": _runtime_state(eng.runtime),
        "cold": (service._cold.state_dict()
                 if service._cold is not None else {}),
        "tenant_saved": {t: dict(s)
                         for t, s in sorted(service._tenant_saved.items())},
    }
    rt_rng = getattr(eng.runtime, "rng", None)
    extra = {
        "spec": _spec_dict(service.spec),
        "rescore_mode": service.rescore_mode,
        "checkpoint_every": service.checkpoint_every,
        "next_event": service._next_event,
        "trace": [ev.to_dict() for ev in service.trace],
        "engine_meta": eng.state_meta(),
        "pool_rng": eng.pool.rng.bit_generator.state,
        "sched_rng": eng.scheduler.rng.bit_generator.state,
        "runtime_rng": (rt_rng.bit_generator.state
                        if rt_rng is not None else None),
        "cold_rng": (service._cold.rng.bit_generator.state
                     if service._cold is not None else None),
        "records": [_record_to_dict(r) for r in eng.records],
        "metrics": service.metrics.to_state(),
        "live": sorted(service._live),
        "queue": list(service._queue),
        "tenant_job": dict(service._tenant_job),
        "job_tenant": {str(j): t for j, t in service._job_tenant.items()},
        "tenant_template": dict(service._tenant_template),
        "rescore_costs": list(service.rescore_costs),
        "num_templates": len(service.templates),
        # Stateless schedulers save EMPTY per-tenant slices (no array
        # leaves), so the tenant list must ride here for the like-tree.
        "tenant_saved_keys": sorted(service._tenant_saved),
    }
    # SLO resilience state (``repro_torch.serve.resilience``): last-good plans,
    # rung/shed counters, breaker board, watchdog stall counts — all JSON.
    # Wall-clock latency windows are deliberately NOT persisted (they are
    # not replayable); they re-fill after resume.
    resilience = {}
    if eng.governor is not None:
        resilience["governor"] = eng.governor.state_dict()
    wd = getattr(service, "_watchdog", None)
    if wd is not None:
        resilience["watchdog"] = wd.state_dict()
    if resilience:
        extra["resilience"] = resilience
    return tree, extra


def save_service_checkpoint(service, event_idx: int) -> str:
    """Atomically persist the service at an event boundary (step =
    number of traffic events already applied)."""
    tree, extra = service_state(service)
    if service._ckpt_manager is None:
        raise ValueError("service has no checkpoint_dir")
    return service._ckpt_manager.save(event_idx, tree, extra)


def read_manifest_extra(directory: str, step: Optional[int] = None) -> dict:
    """The JSON half of the newest (or given) committed step — enough to
    rebuild the construction-time skeleton before touching any arrays."""
    import json
    import os

    from repro_torch.checkpoint import step_path

    steps = committed_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no committed checkpoints in {directory}")
    step = steps[-1] if step is None else step
    with open(os.path.join(step_path(directory, step), "manifest.json")) as f:
        return json.load(f)["extra"]


def _like_tree(service, extra: dict) -> dict:
    """A structural twin of the saved tree built from the REBUILT skeleton
    (leaf shapes are irrelevant — ``load_checkpoint`` takes shapes from the
    stored arrays and only dtypes/structure from ``like``)."""
    eng = service.engine
    like_engine = eng.state_arrays()   # fresh skeleton: inflight is empty
    like_engine["inflight"] = {
        key: {k: np.zeros(0, dt) for k, dt in _INFLIGHT_DTYPES.items()}
        for key in extra["engine_meta"]["inflight"]}
    sched = eng.scheduler
    like = {
        "engine": like_engine,
        "pool": eng.pool.state_dict(),
        "scheduler": sched.state_dict(),
        "runtime": _runtime_state(eng.runtime),
        "cold": (service._cold.state_dict()
                 if service._cold is not None else {}),
        # Any job's slice has the per-job structure (shapes don't matter).
        "tenant_saved": {t: dict(sched.job_state_dict(0))
                         for t in extra["tenant_saved_keys"]},
    }
    # Tensor leaves stay tensors: they give the restored leaves their dtype
    # and device.
    return tree_map(lambda a: a if isinstance(a, torch.Tensor)
                    else np.asarray(a), like)


def restore_service(service, directory: str,
                    step: Optional[int] = None) -> int:
    """Load the newest (or given) committed step into an already-constructed
    service whose skeleton matches (same spec, dynamic jobs re-added).
    Returns the restored step (= events already applied)."""
    extra = read_manifest_extra(directory, step)
    eng = service.engine

    # Re-add the dynamic (arrival-instantiated) jobs in id order so every
    # per-job row — pool column, counts, scheduler ring, runtime row —
    # exists with the saved shape before any array lands.
    n_templates = int(extra["num_templates"])
    n_jobs = len(extra["engine_meta"]["jobs"])
    job_tenant = {int(j): t for j, t in extra["job_tenant"].items()}
    for j in range(n_templates, n_jobs):
        template = int(extra["tenant_template"][job_tenant[j]])
        jid = eng.add_job(service.templates[template],
                          data_sizes=service.template_data[template],
                          launch=False)
        assert jid == j, (jid, j)

    step, tree, _ = load_checkpoint(directory, _like_tree(service, extra),
                                    step=step)

    eng.pool.load_state_dict(tree["pool"])
    eng.pool.rng.bit_generator.state = extra["pool_rng"]
    eng.load_state(tree["engine"], extra["engine_meta"])
    eng.scheduler.load_state_dict(tree["scheduler"])
    eng.scheduler.rng.bit_generator.state = extra["sched_rng"]
    if tree["runtime"]:
        eng.runtime.load_state_dict(tree["runtime"])
    if extra["runtime_rng"] is not None:
        eng.runtime.rng.bit_generator.state = extra["runtime_rng"]
    if service._cold is not None:
        if tree["cold"]:
            service._cold.load_state_dict(tree["cold"])
        if extra["cold_rng"] is not None:
            service._cold.rng.bit_generator.state = extra["cold_rng"]
    eng.records = [_record_from_dict(d) for d in extra["records"]]

    service.metrics.load_state(extra["metrics"])
    service._live = set(int(j) for j in extra["live"])
    service._queue = list(extra["queue"])
    service._tenant_job = {t: int(j)
                           for t, j in extra["tenant_job"].items()}
    service._job_tenant = job_tenant
    service._tenant_template = {t: int(v) for t, v
                                in extra["tenant_template"].items()}
    service._tenant_saved = {t: dict(tree["tenant_saved"].get(t, {}))
                             for t in extra["tenant_saved_keys"]}
    service.rescore_costs = list(extra["rescore_costs"])
    service._rescore_cache = {}   # memo of pure functions: rebuilt on miss
    service.trace = [TrafficEvent.from_dict(d) for d in extra["trace"]]
    service._next_event = int(extra["next_event"])

    # SLO resilience state (.get: pre-SLO checkpoints lack the key).
    resilience = extra.get("resilience") or {}
    if eng.governor is not None and resilience.get("governor") is not None:
        eng.governor.load_state_dict(resilience["governor"])
    wd = getattr(service, "_watchdog", None)
    if wd is not None and resilience.get("watchdog") is not None:
        wd.load_state_dict(resilience["watchdog"])
    sync = getattr(service, "_sync_queue_depth", None)
    if sync is not None:
        sync()

    # Re-announce in-flight cohorts to batching runtimes (the pre-crash
    # announcement died with the process; SyntheticRuntime has no hook).
    begin = getattr(eng.runtime, "begin_round", None)
    if begin is not None:
        for job, f in eng._in_flight.items():
            begin(job, f["survivors"], eng.jobs[job].round_idx)
    return step
