"""The online multi-tenant scheduler service.

``SchedulerService`` wraps a built ``MultiJobEngine`` in an event loop that
interleaves EXTERNAL traffic (job arrivals/departures, device churn — a
``repro_torch.serve.traffic`` trace) with the engine's INTERNAL round events
(``engine.advance_until``). The spec's job list becomes a catalogue of
tenant templates: template jobs are parked (never run), and every arrival
instantiates a fresh engine job from its template.

Admission control: at most ``arrivals.max_concurrent`` live jobs; excess
arrivals queue and are admitted least-served-first when a slot frees (a job
finishes or its tenant departs) — Jain-fairness-aware admission.

Per-arrival plan rescoring (the admission decision's cost estimate for
every live job under the post-arrival world state) runs in one of two modes:

- ``incremental`` — rescore each live job's CURRENT plan through the
  batched scoring core, reusing the pool's SoA caches and skipping jobs
  whose world is unchanged (``pool.version`` + round index as the cache
  key). Churn invalidates exactly the affected entries.
- ``full``        — re-run a cold scheduler's complete plan SEARCH for
  every live job (the ablation baseline the incremental path is measured
  against).

Both modes are ADVISORY: executed plans always come from the live
scheduler inside the engine, so the realized trajectory is identical across
modes, so decision latency compares at equal outcomes.

Device: the service's tensor work (the ``torch``/``cuda`` scoring backends,
the fused searches, the ``real_fl`` runtime) runs on ``device``, ``"cuda"``
unless the caller asks for the CPU; ``resume`` takes it from its caller,
never from the checkpoint, which holds host arrays only. With
``scoring_backend="cuda"`` every incremental rescore is one (1, K) launch
of the plan-scoring kernel (2.1).

Warm hand-off: a departing tenant's per-job scheduler state
(``job_state_dict`` — BODS observation ring, RLDS baseline) is saved and
reloaded under the new job id if the tenant is readmitted, BEFORE its first
decision (``add_job(launch=False)`` + ``launch_job``).
"""

from __future__ import annotations

import time
import warnings
from typing import Dict, List, Optional, Set

import numpy as np

from repro_torch.core.multijob import MultiJobEngine, RoundRecord
from repro_torch.experiment.spec import ExperimentSpec
from repro_torch.monitoring.trace import instant, span
from repro_torch.serve.metrics import ServiceMetrics, ServiceReport
from repro_torch.serve.resilience import RoundWatchdog
from repro_torch.serve.traffic import TrafficEvent, trace_from_spec

RESCORE_MODES = ("incremental", "full")


class SimulatedCrash(RuntimeError):
    """In-process stand-in for ``kill -9`` (the ``crash_after`` test hook):
    raised AFTER the Nth traffic event is applied, past any checkpoint for
    that boundary — state on disk is whatever the last atomic save
    committed, exactly like a hard kill."""


class SchedulerService:
    def __init__(self, spec: ExperimentSpec,
                 rescore_mode: str = "incremental",
                 verbose: bool = False,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 0,
                 crash_after: Optional[int] = None,
                 device: str = "cuda"):
        """``checkpoint_dir``/``checkpoint_every``: atomically persist the
        FULL service state every N traffic events (``repro_torch.serve.
        persistence``); ``resume()`` restarts bit-identically from the
        newest committed step. ``crash_after``: raise ``SimulatedCrash``
        after the Nth event (chaos tests). ``device``: where the engine's
        tensor work runs."""
        if spec.arrivals is None:
            raise ValueError("SchedulerService needs spec.arrivals "
                             "(the online traffic axis)")
        if rescore_mode not in RESCORE_MODES:
            raise ValueError(f"rescore_mode {rescore_mode!r} not in "
                             f"{RESCORE_MODES}")
        self.spec = spec
        self.device = str(device)
        self.rescore_mode = rescore_mode
        self.verbose = verbose
        self.checkpoint_every = int(checkpoint_every)
        self.checkpoint_dir = checkpoint_dir
        self._ckpt_manager = None
        if checkpoint_dir is not None:
            from repro_torch.checkpoint import CheckpointManager

            self._ckpt_manager = CheckpointManager(checkpoint_dir)
        self.crash_after = crash_after
        self.trace: Optional[List[TrafficEvent]] = None
        self._next_event = 0   # resume cursor: traffic events already applied

        # SLO resilience axis: backpressure thresholds, the watchdog, and
        # (inside the engine) the decision governor + breakers.
        self._slo = spec.effective_slo()
        self._watchdog = (RoundWatchdog(self._slo.watchdog_rounds)
                          if self._slo is not None
                          and self._slo.watchdog_rounds > 0 else None)
        self._draining = False   # post-trace drain forces deferred admits

        self.engine: MultiJobEngine = self._fresh_engine()
        eng = self.engine
        # The catalogue: template configs + their data-size columns.
        self.templates = [js.config for js in eng.jobs]
        self.template_data = [eng.pool.data_sizes[:, i].copy()
                              for i in range(len(self.templates))]

        self.metrics = ServiceMetrics()
        self._live: Set[int] = set()            # admitted, not finished
        self._tenant_job: Dict[str, int] = {}   # live tenant -> job id
        # Job ids are never reused, so job -> tenant is PERMANENT — a
        # retired tenant's in-flight round still finishes (and must still
        # be attributed) after its slot is released.
        self._job_tenant: Dict[int, str] = {}
        self._tenant_template: Dict[str, int] = {}
        self._tenant_saved: Dict[str, dict] = {}  # retired -> per-job state
        self._queue: List[str] = []             # tenants waiting for a slot
        # Incremental rescoring memo: job -> ((pool.version, round_idx), cost)
        self._rescore_cache: Dict[int, tuple] = {}
        # Advisory mean rescore cost per admission (the modes' parity data).
        self.rescore_costs: List[float] = []
        self._cold = (self._make_cold_scheduler()
                      if rescore_mode == "full" else None)
        self.last_report: Optional[ServiceReport] = None

    # ---- crash-consistent persistence ----

    @classmethod
    def resume(cls, checkpoint_dir: str, verbose: bool = False,
               crash_after: Optional[int] = None,
               device: str = "cuda") -> "SchedulerService":
        """Rebuild a service from the newest committed checkpoint (the
        port's or the reference's) on ``device`` and position it at the
        saved event boundary; a subsequent ``run()`` continues the SAME
        trajectory bit-for-bit."""
        from repro_torch.serve.persistence import (read_manifest_extra,
                                             restore_service)

        extra = read_manifest_extra(checkpoint_dir)
        svc = cls(ExperimentSpec.from_dict(extra["spec"]),
                  rescore_mode=extra["rescore_mode"], verbose=verbose,
                  checkpoint_dir=checkpoint_dir,
                  checkpoint_every=int(extra["checkpoint_every"]),
                  crash_after=crash_after, device=device)
        restore_service(svc, checkpoint_dir)
        return svc

    # ---- construction helpers ----

    def _fresh_engine(self) -> MultiJobEngine:
        """Build the construction-time engine skeleton (also the watchdog-
        recovery rebuild path): template jobs parked — they exist so
        build()/calibration see a valid job mix, but only
        arrival-instantiated jobs ever run — and the done-callback wired."""
        eng = self.spec.build(device=self.device).engine
        for js in eng.jobs:
            js.parked = True
            js.done = True
        eng.on_job_done = self._on_job_done
        return eng

    def _make_cold_scheduler(self):
        """A second scheduler instance for the ``full`` ablation: same
        registry entry and knobs, own seed/rng (so its advisory searches
        never perturb the live scheduler's decision stream), and no
        pre-training (RLDS) — it re-searches from the current world state,
        which is the point."""
        from repro_torch.experiment.registry import SCHEDULERS

        spec = self.spec
        kwargs = {"cost_model": self.engine.cost_model,
                  "seed": spec.scheduler_seed + 10_000,
                  **spec._candidate_kwargs(),
                  **dict(spec.scheduler_kwargs)}
        if "pretrain_rounds" in spec._scheduler_params():
            kwargs["pretrain_rounds"] = 0
        return SCHEDULERS.create(spec.scheduler, **kwargs)

    # ---- engine callbacks ----

    def _on_round(self, rec: RoundRecord) -> None:
        self.metrics.rounds_completed += 1
        if rec.rung is not None and rec.rung != "full":
            self.metrics.degraded_rounds += 1
        tenant = self._job_tenant.get(rec.job)
        gov = self.engine.governor
        if gov is not None and gov.breakers is not None:
            # Simulated-time breaker feedback: the round's end instant.
            for ch in gov.note_round(rec, tenant, rec.t_end):
                if ch["state"] == "open":
                    self.metrics.breaker_trips += 1
                if self.engine.events is not None:
                    self.engine.events.publish("serve.breaker", ch)
        if tenant is None:
            return
        ts = self.metrics.tenants[tenant]
        ts.rounds += 1
        ts.total_cost += rec.cost
        ts.total_round_time += rec.round_time
        ts.last_fairness = rec.fairness
        ts.best_accuracy = max(ts.best_accuracy, rec.accuracy)

    def _on_job_done(self, job: int, now: float) -> None:
        """Engine signal: a job finished naturally (target/max_rounds) —
        free its admission slot and drain the queue."""
        self._release(job, now)

    # ---- admission control ----

    def _sync_queue_depth(self) -> None:
        """Mirror the admission queue into the governor (its deterministic
        queue-pressure input for the degradation ladder)."""
        gov = self.engine.governor
        if gov is not None:
            gov.queue_depth = len(self._queue)

    def _latency_pressure(self) -> bool:
        """Is the rolling p99 decision latency over the SLO deadline? (The
        wall-clock admission-backpressure signal; False without a
        deadline.)"""
        slo = self._slo
        if slo is None or slo.decision_deadline_ms is None:
            return False
        gov = self.engine.governor
        return gov is not None and gov.rolling_p99() > slo.decision_deadline_ms

    def _shed(self, tenant: str, now: float, reason: str) -> None:
        self.metrics.shed_arrivals += 1
        if self.engine.events is not None:
            self.engine.events.publish("serve.shed", dict(
                tenant=tenant, t=now, reason=reason, action="shed",
                queue_depth=len(self._queue)))
        if self.verbose:
            print(f"[t={now:9.1f}s] shed   {tenant} ({reason})")

    def _release(self, job: int, now: float) -> None:
        tenant = self._job_tenant.get(job)
        if tenant is not None and self._tenant_job.get(tenant) == job:
            self._tenant_job.pop(tenant)
        self._live.discard(job)
        self._rescore_cache.pop(job, None)
        self._drain_queue(now)

    def _drain_queue(self, now: float, force: bool = False) -> None:
        force = force or self._draining
        while self._queue and len(self._live) < self.spec.arrivals.max_concurrent:
            if not force and self._latency_pressure():
                # Overload: keep deferring even though a slot is free; the
                # post-trace drain (and any later release once the window
                # cools) picks the queue back up.
                break
            # Least-served first: the tenant with the fewest rounds across
            # ALL its admissions gets the freed slot.
            self._queue.sort(key=lambda t: self.metrics.tenants[t].rounds)
            tenant = self._queue.pop(0)
            queued_at = self.metrics.tenants[tenant].queued_at
            if queued_at is not None:
                wait = float(now - queued_at)
                instant("queue_wait", tenant=tenant, wait_s=wait)
                if self.engine.events is not None:
                    self.engine.events.publish("serve.queue_wait", dict(
                        tenant=tenant, t=now, wait_s=wait))
            self.metrics.tenants[tenant].queued_at = None
            self._sync_queue_depth()
            self._admit(tenant, self._tenant_template[tenant], now)
        self._sync_queue_depth()

    def _admit(self, tenant: str, template: int, now: float) -> None:
        t0 = time.perf_counter()
        self._rescore(now)
        eng = self.engine
        job = eng.add_job(self.templates[template],
                          data_sizes=self.template_data[template],
                          now=now, launch=False)
        saved = self._tenant_saved.pop(tenant, None)
        if saved is not None:
            # Warm hand-off: the tenant's history lands under its NEW job
            # id before the first decision is made.
            eng.scheduler.load_job_state(job, saved)
            self.metrics.readmissions += 1
        eng.launch_job(job, now)
        self.metrics.decision_latency.add(time.perf_counter() - t0)
        self.metrics.decisions += 1
        self._live.add(job)
        self._tenant_job[tenant] = job
        self._job_tenant[job] = tenant
        self.metrics.tenants[tenant].admissions += 1
        if eng.events is not None:
            eng.events.publish("serve.admit", dict(
                tenant=tenant, job=job, template=template, t=now,
                live=len(self._live), warm=saved is not None))
        if self.verbose:
            print(f"[t={now:9.1f}s] admit  {tenant} -> job{job} "
                  f"(template {template}, live={len(self._live)})")

    # ---- incremental plan rescoring ----

    def _rescore(self, now: float) -> Dict[int, float]:
        """Advisory cost estimate of every live job's plan under the
        current world state — the admission decision's inputs."""
        eng = self.engine
        costs: Dict[int, float] = {}
        with span("rescore", mode=self.rescore_mode, live=len(self._live)):
            for job in sorted(self._live):
                if eng.jobs[job].done:
                    continue
                if self.rescore_mode == "incremental":
                    key = (eng.pool.version, eng.jobs[job].round_idx)
                    cached = self._rescore_cache.get(job)
                    if cached is not None and cached[0] == key:
                        costs[job] = cached[1]
                        continue
                    # Score the job's CURRENT plan under the post-churn time
                    # model — wait-free (its own devices are mid-round busy;
                    # full-search also plans over wait-free devices, so this
                    # is the comparable quantity). ``pool.expected_times`` is
                    # the per-(job, tau) memo that churn invalidation
                    # refreshes: unchanged world -> pure cache lookups end to
                    # end.
                    cm = eng.cost_model
                    tau = eng.jobs[job].config.local_epochs
                    times = eng.pool.expected_times(job, tau)
                    f = eng._in_flight.get(job)
                    if f is not None:
                        plan = f["plan"]
                    else:
                        # Between rounds (waiting on a retry): cheapest-n
                        # closed-form stand-in.
                        plan = np.zeros(eng.pool.num_devices, dtype=bool)
                        plan[np.argsort(times)[: eng.n_sel]] = True
                    c = float(cm.total_cost_batch(
                        job=job, tau=tau, counts=eng.counts[job],
                        plans=plan[None], other_costs=0.0, times=times)[0])
                    self._rescore_cache[job] = (key, c)
                    costs[job] = c
                else:
                    self._cold.ensure_jobs(len(eng.jobs))
                    ctx = eng._make_ctx(job, now)
                    self._cold.schedule(ctx)
                    est = self._cold.last_estimated_cost
                    costs[job] = float(est) if est is not None else 0.0
        self.rescore_costs.append(
            float(np.mean(list(costs.values()))) if costs else 0.0)
        return costs

    # ---- traffic handling ----

    def _handle(self, ev: TrafficEvent) -> None:
        now = ev.t
        eng = self.engine
        if ev.kind == "arrive":
            self.metrics.arrivals += 1
            template = (ev.template if ev.template is not None
                        else self._tenant_template.get(ev.tenant, 0))
            self._tenant_template[ev.tenant] = template
            self.metrics.tenant(ev.tenant, template)
            if ev.tenant in self._tenant_job or ev.tenant in self._queue:
                return  # duplicate arrival of a live/queued tenant
            slo = self._slo
            gov = eng.governor
            # Circuit breaker: an open tenant breaker sheds the arrival
            # outright (allow() also grants the half-open probe admission).
            if (gov is not None and gov.breakers is not None
                    and not gov.breakers.tenant(ev.tenant).allow(now)):
                self._shed(ev.tenant, now, "breaker_open")
                return
            # Queue-depth bound: beyond it the arrival is shed, not queued.
            if (slo is not None and slo.max_queue_depth is not None
                    and len(self._queue) >= slo.max_queue_depth):
                self._shed(ev.tenant, now, "queue_full")
                return
            if len(self._live) < self.spec.arrivals.max_concurrent:
                if self._latency_pressure():
                    # Rolling p99 over the deadline: the decision path is
                    # overloaded, so don't add work even though a slot is
                    # free — defer (queue) or shed per policy.
                    if slo.shed_policy == "shed":
                        self._shed(ev.tenant, now, "latency")
                        return
                    self.metrics.deferrals += 1
                    self.metrics.tenants[ev.tenant].queued_at = now
                    self._queue.append(ev.tenant)
                    self._sync_queue_depth()
                    if eng.events is not None:
                        eng.events.publish("serve.shed", dict(
                            tenant=ev.tenant, t=now, reason="latency",
                            action="defer", queue_depth=len(self._queue)))
                    if self.verbose:
                        print(f"[t={now:9.1f}s] defer  {ev.tenant} "
                              f"(depth={len(self._queue)})")
                    return
                self._admit(ev.tenant, template, now)
            else:
                self.metrics.rejections += 1
                self.metrics.tenants[ev.tenant].queued_at = now
                self._queue.append(ev.tenant)
                self._sync_queue_depth()
                if self.verbose:
                    print(f"[t={now:9.1f}s] queue  {ev.tenant} "
                          f"(depth={len(self._queue)})")
        elif ev.kind == "depart":
            self.metrics.departures += 1
            if ev.tenant in self._queue:
                self._queue.remove(ev.tenant)
                self._sync_queue_depth()
                return
            job = self._tenant_job.get(ev.tenant)
            if job is None:
                return  # already finished (slot released via on_job_done)
            self._tenant_saved[ev.tenant] = eng.scheduler.job_state_dict(job)
            eng.retire_job(job, now=now)
            if eng.events is not None:
                eng.events.publish("serve.depart", dict(
                    tenant=ev.tenant, job=job, t=now))
            if self.verbose:
                print(f"[t={now:9.1f}s] retire {ev.tenant} (job{job})")
            self._release(job, now)
        elif ev.kind == "churn_out":
            self.metrics.churn_events += 1
            eng.pool.depart(ev.devices)
            if eng.events is not None:
                eng.events.publish("serve.churn", dict(
                    kind="out", t=now, n=len(ev.devices)))
        elif ev.kind == "churn_in":
            self.metrics.churn_events += 1
            if ev.drift != 1.0:
                ids = np.asarray(ev.devices)
                eng.pool.rejoin(ids, a=eng.pool.a[ids] * ev.drift)
            else:
                eng.pool.rejoin(ev.devices)
            if eng.events is not None:
                eng.events.publish("serve.churn", dict(
                    kind="in", t=now, n=len(ev.devices), drift=ev.drift))

    # ---- the event loop ----

    def run(self, trace: Optional[List[TrafficEvent]] = None
            ) -> ServiceReport:
        """Sustain the traffic stream end-to-end: for each traffic event,
        advance the engine's internal heap up to the event's timestamp,
        apply the event, then drain the remaining rounds. Returns the
        service report; per-job engine summaries stay on
        ``self.engine.summary()``."""
        arr = self.spec.arrivals
        if trace is None:
            # A resumed service replays ITS OWN saved trace (regenerating
            # would fork the trajectory if the spec's seed axis changed).
            trace = self.trace if self.trace is not None else trace_from_spec(
                arr, len(self.templates), self.engine.pool.num_devices)
        self.trace = trace
        t0 = time.perf_counter()
        try:
            # While-loop over the resume cursor (not a range): watchdog
            # recovery rewinds ``_next_event`` and swaps ``self.engine``
            # mid-run, so both are re-read every iteration.
            while self._next_event < len(self.trace):
                eng = self.engine
                i = self._next_event
                ev = self.trace[i]
                with span("serve_advance", until=ev.t):
                    eng.advance_until(ev.t, on_round=self._on_round)
                with span("handle_event", kind=ev.kind):
                    self._handle(ev)
                self.metrics.events_processed += 1
                self.metrics.sample_queue_depth(len(self._queue))
                self._next_event = i + 1
                if (self._ckpt_manager is not None
                        and self.checkpoint_every > 0
                        and self._next_event % self.checkpoint_every == 0):
                    from repro_torch.serve.persistence import save_service_checkpoint

                    with span("checkpoint_write", step=self._next_event):
                        save_service_checkpoint(self, self._next_event)
                    if eng.events is not None:
                        eng.events.publish("serve.checkpoint", dict(
                            step=self._next_event, t=ev.t))
                if (self.crash_after is not None
                        and self._next_event >= self.crash_after):
                    raise SimulatedCrash(
                        f"crash_after={self.crash_after}: simulated hard "
                        f"kill after event {self._next_event}")
                if self._watchdog is not None:
                    self._watchdog_tick(ev.t)
            # Drain: live jobs run to completion; finishing jobs release
            # slots, which admits queued tenants mid-drain (on_job_done
            # fires inside advance_until, so late admissions still execute).
            # ``_draining`` lifts the p99 deferral hold first.
            self._draining = True
            self._drain_queue(self.engine.clock, force=True)
            with span("serve_advance", until=float("inf")):
                self.engine.advance_until(np.inf, on_round=self._on_round)
        finally:
            # The spec's obs axis hung a session on the engine at build();
            # the service owns the run, so it finalizes (trace write + sink
            # close) even on a simulated crash.
            if self.engine.obs is not None:
                self.engine.obs.close()
        self.last_report = self.metrics.report(
            sim_horizon=arr.horizon, wall_s=time.perf_counter() - t0,
            resilience=self.resilience_summary())
        return self.last_report

    # ---- watchdog recovery ----

    def _watchdog_tick(self, now: float) -> None:
        wedged = self._watchdog.check(self.engine)
        if not wedged:
            return
        eng = self.engine
        if eng.events is not None:
            eng.events.publish("serve.stall", dict(
                jobs=list(wedged), t=now,
                recoveries=self.metrics.recoveries))
        can_restore = (self._ckpt_manager is not None
                       and self.metrics.recoveries < self._slo.max_recoveries)
        if can_restore:
            from repro_torch.checkpoint import committed_steps

            can_restore = bool(committed_steps(self.checkpoint_dir))
        if can_restore:
            self._recover(now, wedged)
        else:
            # No committed snapshot (or recovery budget exhausted): best
            # effort — push the wedged jobs back into the event loop.
            warnings.warn(
                f"watchdog: jobs {wedged} stalled with no usable checkpoint "
                "(or max_recoveries reached); re-launching them in place",
                RuntimeWarning)
            for j in wedged:
                eng._launch(j, max(eng.clock, now))
            self._watchdog.reset()

    def _recover(self, now: float, wedged: List[int]) -> None:
        """Rebuild the engine skeleton and restore the newest committed
        checkpoint IN PLACE, rewinding the traffic cursor to the saved
        boundary — the run loop then replays forward deterministically."""
        from repro_torch.serve.persistence import restore_service

        warnings.warn(
            f"watchdog: jobs {wedged} stalled for "
            f"{self._slo.watchdog_rounds} checks; restoring from the newest "
            f"checkpoint in {self.checkpoint_dir}", RuntimeWarning)
        if self.engine.obs is not None:
            self.engine.obs.close()
        self.engine = self._fresh_engine()
        if self.rescore_mode == "full":
            self._cold = self._make_cold_scheduler()
        # Reset the dynamic maps to construction state so restore_service
        # re-adds the arrival-instantiated jobs onto a clean skeleton.
        self._live = set()
        self._queue = []
        self._tenant_job = {}
        self._job_tenant = {}
        self._tenant_template = {}
        self._tenant_saved = {}
        self._rescore_cache = {}
        step = restore_service(self, self.checkpoint_dir)
        self.metrics.recoveries += 1
        self._watchdog.reset()
        self._sync_queue_depth()
        if self.engine.events is not None:
            self.engine.events.publish("serve.recovered", dict(
                t=now, step=step, jobs=list(wedged),
                recoveries=self.metrics.recoveries))
        if self.verbose:
            print(f"[t={now:9.1f}s] recovered from checkpoint step {step} "
                  f"(stalled jobs {wedged})")

    # ---- resilience reporting ----

    def resilience_summary(self) -> Optional[dict]:
        """Degradation/shed/breaker/recovery accounting for the report
        (None when the SLO axis is off)."""
        gov = self.engine.governor
        if gov is None and self._slo is None:
            return None
        out = gov.summary() if gov is not None else {}
        out.update(
            shed_arrivals=self.metrics.shed_arrivals,
            deferrals=self.metrics.deferrals,
            recoveries=self.metrics.recoveries,
            breaker_trips=self.metrics.breaker_trips,
            degraded_rounds=self.metrics.degraded_rounds)
        return out
