"""Event-driven multi-job FL engine (the paper's Fig. 1 process).

M jobs run in PARALLEL and asynchronously share the K-device pool: at any
simulated instant a device belongs to at most one job. Each job round:

  (1)-(2) the scheduler picks V_m^r from the currently-available devices,
  (3)-(5) the scheduled devices run local training (their realized times are
          sampled from the shifted-exponential model; the slowest defines the
          round time, Formula 3),
  (6)     the server aggregates (FedAvg) — executed by the pluggable
          ``JobRuntime`` which performs REAL training on partitioned data,
          exactly like the paper's GPU-simulated testbed (times simulated,
          accuracy real).

The engine keeps a completion-time heap; when a round finishes, the realized
cost feeds back to the scheduler (BODS observation point / RLDS reward) and
the next round of that job is scheduled at the release instant. Devices are
released individually when THEIR local work ends (a fast device that
finished uploading can immediately join another job).

Fault tolerance: the ``faults`` axis (``repro_torch.faults.FaultSpec``) injects a
replayable per-round fault schedule — transient dropouts with escalating
quarantine (exponential backoff, reset on success), permanent crashes,
straggler slowdown multipliers, correlated fault-domain outages, and
corrupted uploads. Dropped devices are excluded from aggregation (FedAvg
over survivors) and the engine proceeds, which is exactly how a production
FL server must behave. ``round_deadline`` adds FedCS-style partial
aggregation: survivors slower than the deadline are cut from the cohort.
The legacy ``failure_rate``/``failure_cooldown`` kwargs remain as a
deprecated alias (uniform dropouts, fixed cooldown). Straggler mitigation:
optional ``over_provision`` factor schedules extra devices and the round
completes when n_sel have finished (deadline on the straggler tail).
"""

from __future__ import annotations

import dataclasses
import heapq
import warnings
from typing import Callable, Dict, List, Optional, Protocol, Sequence

import numpy as np

from repro_torch.config.base import JobConfig
from repro_torch.core.cost import CostModel
from repro_torch.core.devices import DevicePool
from repro_torch.core.schedulers.base import SchedulerBase, SchedulingContext
from repro_torch.faults import FaultEngine, FaultSpec
from repro_torch.monitoring.trace import span

_EMPTY_IDS = np.array([], dtype=int)


class JobRuntime(Protocol):
    """Executes the real training for one round of one job.

    The engine resolves the ROUND'S REALIZED participation at launch time
    (over-provisioned stragglers cut, failed devices dropped) and hands the
    runtime the surviving cohort twice: once through the optional
    ``begin_round`` hook at launch (so batching runtimes can overlap/fuse
    training of concurrently in-flight jobs), and once through ``run_round``
    at the simulated finish instant, which must return the metrics."""

    def run_round(self, job_id: int, device_ids: np.ndarray, round_idx: int
                  ) -> Dict[str, float]:
        """Train the scheduled devices locally + aggregate. ``device_ids`` is
        the realized survivor cohort (the engine's weight mask: exactly these
        devices aggregate). Returns metrics with at least
        {'loss': float, 'accuracy': float}."""

    # Optional: ``begin_round(job_id, device_ids, round_idx)`` — same
    # realized cohort, announced when the round LAUNCHES. Runtimes that
    # batch cross-job execution queue work here and flush every pending job in one dispatch at the
    # first ``run_round`` demand.


@dataclasses.dataclass
class RoundRecord:
    job: int
    round_idx: int
    t_start: float
    t_end: float
    round_time: float
    cost: float
    fairness: float
    loss: float
    accuracy: float
    device_ids: np.ndarray
    dropped: np.ndarray
    # Scheduler's estimated Formula-2 cost of the plan at schedule time (None
    # for schedulers that don't estimate); cost - est_cost is the realized
    # residual the learned schedulers (BODS GP, DNN) model.
    est_cost: Optional[float] = None
    # Degraded round: every scheduled device failed (or missed the deadline)
    # and the engine fell back to aggregating the single fastest reporter.
    degraded: bool = False
    # Devices whose uploads were drawn corrupted this round (rejected by a
    # robust runtime, or oracle-discarded by the engine otherwise).
    corrupt_ids: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([], dtype=int))
    # Fault-failed devices this round (subset of ``dropped``; the breaker
    # board keys tenant/domain health on these).
    failed_ids: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([], dtype=int))
    # SLO axis: which degradation-ladder rung produced the plan (None when
    # no governor is attached) and the measured decision latency in ms
    # (recorded ONLY when a wall-clock deadline is active — it is not
    # replayable, so the deterministic modes keep records bit-identical).
    rung: Optional[str] = None
    decision_ms: Optional[float] = None


@dataclasses.dataclass
class JobState:
    config: JobConfig
    round_idx: int = 0
    done: bool = False
    reached_target_at: Optional[float] = None
    total_round_time: float = 0.0  # Σ_r T_m^r (Formula 6 numerator)
    # Online-service lifecycle (dynamic job sets): when the job was admitted
    # to the engine, and whether/when it was retired EARLY (tenant departure
    # — distinct from finishing by target/max_rounds).
    admitted_at: float = 0.0
    retired: bool = False
    retired_at: Optional[float] = None
    # Set once the job enters the event loop (in flight or retry pending);
    # run() skips launched jobs so mixing manual launches / dynamic
    # admission with a later run() never double-books a job's events.
    launched: bool = False
    # Catalogue rows: the scheduler service builds the engine from a spec
    # whose jobs are tenant TEMPLATES, never run directly; parked jobs are
    # skipped by run()/summary().
    parked: bool = False


class MultiJobEngine:
    def __init__(
        self,
        jobs: Sequence[JobConfig],
        pool: DevicePool,
        cost_model: CostModel,
        scheduler: SchedulerBase,
        runtime: JobRuntime,
        n_sel: Optional[int] = None,
        failure_rate: float = 0.0,
        failure_cooldown: float = 60.0,
        over_provision: float = 1.0,
        release_horizon: float = 0.0,
        rng: Optional[np.random.Generator] = None,
        faults: Optional[FaultSpec] = None,
    ):
        """``release_horizon``: the paper's appendix notes BODS/RLDS "consider
        the probability to release the devices in V_o". With horizon h > 0, a
        device freeing within h*time_scale is schedulable NOW; its remaining
        busy time is added to its expected/realized round time (so a nearly-
        free fast device can beat a free slow one). h = 0 is paper-faithful
        strict availability.

        ``faults``: the fault model (``repro_torch.faults.FaultSpec``, or a live
        ``FaultEngine``). The legacy ``failure_rate``/``failure_cooldown``
        kwargs are a deprecated alias: when ``faults`` is None and
        ``failure_rate > 0`` they map onto a uniform-dropout FaultSpec with
        a fixed cooldown (``FaultSpec.from_legacy``)."""
        self.jobs = [JobState(config=j) for j in jobs]
        self.pool = pool
        self.cost_model = cost_model
        self.scheduler = scheduler
        self.runtime = runtime
        self.n_sel = n_sel or max(1, int(round(0.1 * pool.num_devices)))
        self.failure_rate = failure_rate
        self.failure_cooldown = failure_cooldown
        if faults is None and failure_rate > 0.0:
            faults = FaultSpec.from_legacy(failure_rate, failure_cooldown)
        if isinstance(faults, FaultSpec):
            faults = (None if faults.inert
                      else FaultEngine(faults, pool.num_devices))
        self.fault_engine: Optional[FaultEngine] = faults
        self.over_provision = over_provision
        # Validate up front: an over-provisioned selection larger than the
        # pool can NEVER be satisfied — the engine would re-enqueue "retry"
        # events forever. Clamp (with a warning) instead of livelocking.
        K = pool.num_devices
        requested = int(round(self.n_sel * self.over_provision))
        if requested > K:
            self.n_sel = min(self.n_sel, K)
            self.over_provision = K / self.n_sel
            warnings.warn(
                f"n_sel*over_provision = {requested} exceeds the pool size "
                f"{K}; clamped to n_sel={self.n_sel}, "
                f"over_provision={self.over_provision:.3f}", RuntimeWarning)
        self.release_horizon = release_horizon
        self.rng = rng or np.random.default_rng(12345)
        self.counts = np.zeros((len(jobs), pool.num_devices))  # S_m (Formula 16)
        self.records: List[RoundRecord] = []
        self.clock = 0.0  # latest processed simulated instant
        # Optional hook for online callers (the scheduler service): called as
        # ``on_job_done(job, now)`` when a job completes (target reached,
        # max_rounds, or abandoned) — the admission-slot release signal.
        self.on_job_done: Optional[Callable[[int, float], None]] = None
        # Observability (the spec's ``obs`` axis): ``events`` is an optional
        # ``repro_torch.monitoring.bus.EventBus`` the engine publishes
        # ``round_begin`` / ``round`` / ``job_done`` to; ``obs`` is the
        # owning ``ObsSession`` (closed when the run ends). Both None by
        # default — the untraced path is unchanged.
        self.events = None
        self.obs = None
        # SLO resilience (``repro_torch.serve.resilience.attach_resilience``):
        # ``governor`` routes scheduling decisions through the degradation
        # ladder; the retry knobs bound the historical retry-forever /
        # fail-fast paths. Defaults keep legacy behavior bit-identically.
        self.governor = None
        self.max_launch_retries: Optional[int] = None
        self.retry_backoff = 2.0
        self.retry_base_delay = 1.0
        self.max_agg_retries = 0
        self._retry_counts: Dict[int, int] = {}
        self._heap: list = []
        self._seq = 0
        self._in_flight: Dict[int, dict] = {}
        self._clamp_warned: set = set()
        # Preallocated per-round scratch (fleet pools: no 100k-sized fresh
        # allocations inside the hot scheduling loop).
        self._times_buf = np.empty(K, dtype=np.float64)
        self._wait_buf = np.empty(K, dtype=np.float64)
        self._busy_buf = np.empty(K, dtype=np.float64)
        self._mask_buf = np.empty(K, dtype=bool)

    # ---- context assembly (Formula 8: other jobs' in-flight costs are context) ----

    def _other_costs(self, job: int) -> float:
        return float(sum(f["cost"] for m, f in self._in_flight.items() if m != job))

    def _wait_times(self, now: float) -> np.ndarray:
        return np.maximum(self.pool.busy_until - now, 0.0)

    def _make_ctx(self, job: int, now: float) -> SchedulingContext:
        js = self.jobs[job]
        wait = self._wait_times(now)
        horizon = self.release_horizon * self.cost_model.time_scale
        return SchedulingContext(
            job=job,
            round_idx=js.round_idx,
            tau=js.config.local_epochs,
            n_sel=int(round(self.n_sel * self.over_provision)),
            available=wait <= horizon + 1e-12,
            counts=self.counts[job].copy(),
            # Queueing-aware expected time: remaining busy time is part of the
            # cost of picking a soon-to-free device.
            expected_times=(self.pool.expected_times(job, js.config.local_epochs)
                            + wait),
            other_costs=self._other_costs(job),
        )

    # ---- schedule one round of one job at simulated time ``now`` ----

    def _launch(self, job: int, now: float) -> None:
        js = self.jobs[job]
        if js.done:
            # Retired (or parked) while a retry event was pending: the
            # stale event must not resurrect the job.
            return
        js.launched = True
        with span("ctx_build", job=job, round=js.round_idx):
            ctx = self._make_ctx(job, now)
            # Populate the context's per-round available-id cache here: the
            # availability-independent derived arrays (float32 time mirror,
            # available-id list) are computed at most once per _make_ctx and
            # reused by greedy/FedCS and the fused searchers instead of being
            # recomputed per candidate batch.
            avail = int(ctx.available_indices().size)
        if avail < ctx.n_sel:
            # Distinguish a transient shortage (devices will free soon) from
            # a PERMANENT one (devices failed forever / selection larger than
            # the reachable pool) — re-enqueueing a retry for the latter
            # would livelock the event loop.
            reachable = int(np.count_nonzero(np.isfinite(self.pool.busy_until)))
            if reachable == 0:
                warnings.warn(f"job {job}: no device can ever become "
                              "available again; abandoning remaining rounds",
                              RuntimeWarning)
                js.done = True
                return
            if reachable < ctx.n_sel:
                if job not in self._clamp_warned:
                    self._clamp_warned.add(job)
                    warnings.warn(
                        f"job {job}: selection {ctx.n_sel} permanently "
                        f"exceeds the {reachable} reachable device(s); "
                        "clamping", RuntimeWarning)
                ctx.n_sel = reachable
            if avail < ctx.n_sel:
                tries = self._retry_counts.get(job, 0)
                if (self.max_launch_retries is not None
                        and tries >= self.max_launch_retries and avail >= 1):
                    # Retry budget exhausted with SOME devices reachable:
                    # launch a clamped cohort now instead of waiting for a
                    # full one (bounded-retry SLO semantics).
                    ctx.n_sel = avail
                else:
                    # Transient: wait for the next FINITE release event —
                    # with a bounded budget, exponential simulated-time
                    # backoff widens each successive wait.
                    b = self.pool.busy_until
                    pending = b[(b > now) & np.isfinite(b)]
                    nxt = float(pending.min()) if pending.size else now + 1.0
                    if self.max_launch_retries is not None:
                        self._retry_counts[job] = tries + 1
                        nxt = max(nxt, now + self.retry_base_delay
                                  * self.retry_backoff ** tries)
                    heapq.heappush(self._heap, (nxt, self._seq, "retry", job))
                    self._seq += 1
                    return
        self._retry_counts.pop(job, None)
        with span("schedule", job=job, round=js.round_idx):
            if self.governor is not None:
                plan, rung, decision_ms, gov_est = self.governor.decide(
                    self.scheduler, ctx, now)
            else:
                plan = self.scheduler.schedule(ctx)
                rung = decision_ms = None
                gov_est = getattr(self.scheduler, "last_estimated_cost", None)
        dispatch_span = span("dispatch", job=job, round=js.round_idx)
        dispatch_span.__enter__()
        fe = self.fault_engine
        # Realized time includes any remaining busy time (release_horizon > 0).
        # Preallocated buffers: valid until this launch returns (nothing
        # below stores a view of them).
        times = self.pool.sample_times_into(
            job, js.config.local_epochs, self._times_buf)
        if fe is not None:
            # Straggler slowdown multiplies COMPUTE time, not queueing wait.
            slow = fe.straggler_multipliers(job, js.round_idx)
            if slow is not None:
                times *= slow
        np.subtract(self.pool.busy_until, now, out=self._wait_buf)
        np.maximum(self._wait_buf, 0.0, out=self._wait_buf)
        times += self._wait_buf
        sel_ids = np.flatnonzero(plan)

        # Straggler mitigation: with over-provisioning the round ends when the
        # n_sel fastest of the scheduled set are done; the tail is dropped.
        sel_times = times[sel_ids]
        if len(sel_ids) > self.n_sel:
            keep = sel_ids[np.argsort(sel_times)[: self.n_sel]]
            dropped_straggler = np.setdiff1d(sel_ids, keep)
        else:
            keep, dropped_straggler = sel_ids, _EMPTY_IDS

        # Fault injection: replayable keyed draws (transient dropouts,
        # permanent crashes, correlated domain outages).
        degraded = False
        if fe is not None:
            transient_m, crash_m, domain_m = fe.failure_masks(job, js.round_idx)
            fail_mask = (transient_m | crash_m | domain_m)[keep]
        else:
            fail_mask = np.zeros(len(keep), dtype=bool)
        failed = keep[fail_mask]
        survivors = keep[~fail_mask]
        if survivors.size == 0 and keep.size:
            # Pathological: everyone failed. Keep the FASTEST reporter (its
            # partial upload is the best single-device aggregate available)
            # and mark the round degraded so summary() can surface it.
            fastest = keep[np.argmin(times[keep])]
            survivors = np.array([fastest])
            failed = keep[keep != fastest]
            degraded = True

        # FedCS-style deadline: partial aggregation over on-time survivors.
        # Late survivors still finish their local work (their devices stay
        # busy until their own end time) but are cut from the cohort; they
        # are NOT failures, so no quarantine strikes.
        deadline_dropped = _EMPTY_IDS
        if fe is not None and fe.spec.round_deadline is not None:
            on_time = survivors[times[survivors] <= fe.spec.round_deadline]
            if on_time.size == 0:
                on_time = survivors[[np.argmin(times[survivors])]]
                degraded = True
            deadline_dropped = np.setdiff1d(survivors, on_time)
            survivors = on_time

        round_time = float(times[survivors].max())
        t_end = now + round_time
        # Devices are busy until THEIR OWN finish time (then free for other jobs).
        per_dev_busy = self._busy_buf  # only masked entries are read by occupy
        per_dev_busy[sel_ids] = now + times[sel_ids]
        if fe is not None:
            # Transient failures escalate (exponential-backoff quarantine,
            # reset on success); domain outages park for the outage duration;
            # crashes are permanent.
            transient_ids = failed[transient_m[failed]]
            domain_ids = failed[domain_m[failed] & ~crash_m[failed]]
            crash_ids = failed[crash_m[failed]]
            per_dev_busy[transient_ids] = (
                t_end + fe.quarantine_durations(transient_ids))
            per_dev_busy[domain_ids] = t_end + fe.spec.domain_outage_duration
            per_dev_busy[crash_ids] = np.inf
            fe.record_success(survivors)
        elif failed.size:
            per_dev_busy[failed] = t_end + self.failure_cooldown
        busy_mask = self._mask_buf
        busy_mask[:] = False
        busy_mask[sel_ids] = True
        self.pool.occupy(busy_mask, per_dev_busy)

        # Corrupted uploads: a robust runtime injects + rejects them inside
        # its own aggregation (``handles_corruption``); otherwise the engine
        # oracle-discards them from the aggregation cohort. Either way they
        # are excluded from the fairness counts (their update never landed).
        corrupt_ids = (fe.corrupt_mask(job, js.round_idx, survivors)
                       if fe is not None else None)
        if corrupt_ids is not None and corrupt_ids.any():
            corrupt_ids = survivors[corrupt_ids]
            counted = np.setdiff1d(survivors, corrupt_ids)
            if not getattr(self.runtime, "handles_corruption", False):
                if counted.size == 0:
                    # Every on-time update is corrupt and nothing can screen
                    # them: aggregate the fastest anyway (degraded round).
                    counted = survivors[[np.argmin(times[survivors])]]
                    degraded = True
                survivors = counted
        else:
            corrupt_ids = _EMPTY_IDS
            counted = survivors

        cm = self.cost_model
        fairness = cm.fairness(self.counts[job], plan)  # paper Formula 5 (absolute, recorded)
        dfair = fairness - cm.fairness(self.counts[job]) if cm.delta_fairness else fairness
        # Realized cost (scheduler feedback): realized straggler time + fairness.
        cost = float(cm.alpha * round_time / cm.time_scale
                     + cm.beta * dfair / cm.fairness_scale)

        # Announce the realized cohort to batching runtimes at LAUNCH time:
        # training is a pure function of (params, survivors), so a fused
        # runtime can execute it any time before the finish event and batch
        # every concurrently in-flight job into one dispatch.
        begin = getattr(self.runtime, "begin_round", None)
        if begin is not None:
            begin(job, survivors, js.round_idx)

        self._in_flight[job] = dict(
            plan=plan, survivors=survivors, counted=counted, failed=failed,
            dropped=np.concatenate(
                [dropped_straggler, failed, deadline_dropped]),
            corrupt=corrupt_ids, degraded=degraded,
            t_start=now, cost=cost, fairness=fairness, round_time=round_time,
            est_cost=gov_est, rung=rung, decision_ms=decision_ms,
            ctx=ctx,
        )
        heapq.heappush(self._heap, (float(t_end), self._seq, "finish", job))
        self._seq += 1
        # Close the dispatch span opened after the scheduling decision (the
        # span is bookkeeping only: an exception above just drops the event).
        dispatch_span.__exit__()
        if self.events is not None:
            self.events.publish("round_begin", dict(
                job=job, round_idx=js.round_idx, t_start=now,
                n_scheduled=int(sel_ids.size), n_survivors=int(survivors.size),
                est_cost=self._in_flight[job]["est_cost"]))

    # ---- round completion ----

    def _finish(self, job: int, now: float) -> bool:
        js = self.jobs[job]
        f = self._in_flight.pop(job)
        with span("aggregate", job=job, round=js.round_idx):
            # Bounded aggregation retries (SLO axis): 0 keeps the historical
            # fail-fast raise; N retries the dispatch, then records a
            # degraded round carrying the job's previous metrics forward.
            tries = 0
            while True:
                try:
                    metrics = self.runtime.run_round(
                        job, f["survivors"], js.round_idx)
                    break
                except Exception as e:
                    if self.max_agg_retries <= 0:
                        raise
                    if tries >= self.max_agg_retries:
                        prev = next((r for r in reversed(self.records)
                                     if r.job == job), None)
                        metrics = {
                            "loss": prev.loss if prev is not None else 0.0,
                            "accuracy": (prev.accuracy
                                         if prev is not None else 0.0)}
                        f["degraded"] = True
                        warnings.warn(
                            f"job {job} round {js.round_idx}: aggregation "
                            f"failed after {tries} retries ({e!r}); "
                            "recording a degraded round", RuntimeWarning)
                        if self.events is not None:
                            self.events.publish("serve.agg_failed", dict(
                                job=job, round_idx=js.round_idx, t=now,
                                retries=tries, error=repr(e)))
                        break
                    tries += 1
        with span("record", job=job, round=js.round_idx):
            self.counts[job][f["counted"]] += 1.0  # Formula 16

            self.records.append(RoundRecord(
                job=job, round_idx=js.round_idx, t_start=f["t_start"],
                t_end=now, round_time=f["round_time"], cost=f["cost"],
                fairness=f["fairness"],
                loss=metrics["loss"], accuracy=metrics["accuracy"],
                device_ids=f["survivors"], dropped=f["dropped"],
                est_cost=f["est_cost"], degraded=f["degraded"],
                corrupt_ids=f["corrupt"], failed_ids=f["failed"],
                rung=f.get("rung"), decision_ms=f.get("decision_ms")))

            self.scheduler.observe(f["ctx"], f["plan"], f["cost"])
            js.total_round_time += f["round_time"]
            js.round_idx += 1

            reached = metrics["accuracy"] >= js.config.target_metric
            if reached and js.reached_target_at is None:
                js.reached_target_at = now
            if reached or js.round_idx >= js.config.max_rounds:
                js.done = True
            # Sink fan-out counts as recording: the metrics/audit JSONL
            # writes happen inside the subscribed sinks.
            if self.events is not None:
                self.events.publish("round", self.records[-1])
        return js.done

    # ---- dynamic job set (online multi-tenant service) ----

    def add_job(self, config: JobConfig,
                data_sizes: Optional[np.ndarray] = None,
                now: Optional[float] = None,
                launch: bool = True,
                runtime_kwargs: Optional[dict] = None) -> int:
        """Admit a NEW job mid-run: grow the pool's data-size columns, the
        fairness-count matrix, the scheduler's per-job state, and the
        runtime's per-job rows, then (if ``now`` is given and ``launch``)
        launch its first round at that simulated instant. ``launch=False``
        defers the first round so the caller can load warm scheduler state
        (a readmitted tenant) before any decision is made.

        ``data_sizes``: the tenant's (K,) per-device data profile; None
        draws a fresh column from the pool's existing range. The runtime
        must expose ``add_job(job_id, config, **runtime_kwargs)`` —
        ``SyntheticRuntime`` does; training runtimes with preallocated
        device-resident datasets do not (yet) support dynamic admission.
        """
        job_id = len(self.jobs)
        config = dataclasses.replace(config, job_id=job_id)
        if self.pool.num_jobs <= job_id:
            self.pool.add_job(data_sizes)
        elif data_sizes is not None:
            self.pool.set_job_data(job_id, data_sizes)
        self.counts = np.concatenate(
            [self.counts, np.zeros((1, self.pool.num_devices))])
        self.jobs.append(JobState(
            config=config,
            admitted_at=float(now) if now is not None else self.clock))
        self.scheduler.ensure_jobs(len(self.jobs))
        add = getattr(self.runtime, "add_job", None)
        if add is None:
            raise TypeError(
                f"runtime {type(self.runtime).__name__} does not support "
                "dynamic job admission (no add_job hook)")
        add(job_id, config, **(runtime_kwargs or {}))
        if now is not None and launch:
            self._launch(job_id, float(now))
        return job_id

    def launch_job(self, job: int, now: float) -> None:
        """Launch the first round of a job admitted with ``launch=False``."""
        self._launch(job, float(now))

    def retire_job(self, job: int, now: Optional[float] = None) -> bool:
        """Retire a job EARLY (tenant departure). An in-flight round runs to
        its finish event (its devices are already committed and its metrics
        still count); nothing is launched afterwards — pending retry events
        die against the ``done`` guard. Returns False if the job had already
        finished."""
        js = self.jobs[job]
        if js.done:
            return False
        js.done = True
        js.retired = True
        js.retired_at = float(now) if now is not None else self.clock
        return True

    # ---- main loop ----

    def advance_until(self, until: float, verbose: bool = False,
                      on_round: Optional[Callable[[RoundRecord], None]] = None
                      ) -> int:
        """Process every queued engine event with timestamp <= ``until``
        (the bounded event loop online callers interleave with external
        traffic events); returns the number of completed rounds."""
        finished = 0
        while self._heap and self._heap[0][0] <= until:
            now, _, kind, job = heapq.heappop(self._heap)
            self.clock = max(self.clock, now)
            if kind == "retry":
                self._launch(job, now)
                continue
            done = self._finish(job, now)
            finished += 1
            if on_round is not None:
                on_round(self.records[-1])
            if verbose:
                r = self.records[-1]
                print(f"[t={now:9.1f}s] job{job} r{r.round_idx} "
                      f"acc={r.accuracy:.4f} loss={r.loss:.4f} T={r.round_time:.1f}s")
            if not done:
                self._launch(job, now)
            else:
                if self.events is not None:
                    self.events.publish("job_done", dict(
                        job=job, t=now, rounds=self.jobs[job].round_idx,
                        retired=self.jobs[job].retired))
                if self.on_job_done is not None:
                    self.on_job_done(job, now)
        return finished

    def run(self, verbose: bool = False,
            on_round: Optional[Callable[[RoundRecord], None]] = None) -> List[RoundRecord]:
        with span("engine_run", jobs=len(self.jobs)):
            for m in range(len(self.jobs)):
                if not self.jobs[m].done and not self.jobs[m].launched:
                    self._launch(m, 0.0)
            self.advance_until(np.inf, verbose=verbose, on_round=on_round)
        return self.records

    # ---- summary (paper Tables 1/2/5 quantities) ----

    def summary(self) -> Dict[str, dict]:
        out = {}
        for m, js in enumerate(self.jobs):
            if js.parked:
                continue  # tenant templates, never executed
            recs = [r for r in self.records if r.job == m]
            key = js.config.model.name
            if key in out:
                key = f"{key}#{m}"
            # All fields must be well-defined for jobs with ZERO completed
            # rounds (abandoned before first finish, or clamped away) — and
            # lifetimes are UNEQUAL under dynamic admission, so every
            # per-job quantity derives from that job's own records only.
            out[key] = dict(
                rounds=js.round_idx,
                final_accuracy=recs[-1].accuracy if recs else 0.0,
                best_accuracy=max((r.accuracy for r in recs), default=0.0),
                time_to_target=js.reached_target_at,
                total_round_time=js.total_round_time,
                mean_round_time=(js.total_round_time / js.round_idx
                                 if js.round_idx else 0.0),
                makespan=recs[-1].t_end if recs else 0.0,
                admitted_at=js.admitted_at,
                retired=js.retired,
                degraded_rounds=sum(1 for r in recs if r.degraded),
                corrupt_updates=sum(len(r.corrupt_ids) for r in recs),
            )
        return out

    # ---- crash-consistent persistence (the serve resume path) ----
    #
    # The engine's state splits into an ARRAY half (a checkpointable pytree:
    # fairness counts, in-flight round arrays, fault strikes) and a JSON
    # half (clock, event heap, per-job lifecycle, RNG states, in-flight
    # scalars). ``repro_torch.serve.persistence`` stores the former through
    # ``repro_torch.checkpoint`` and the latter in the manifest's ``extra``;
    # ``repro_torch.convert`` carries both halves across from the reference
    # engine.

    def state_arrays(self) -> dict:
        inflight = {}
        for j, f in sorted(self._in_flight.items()):
            ctx = f["ctx"]
            inflight[str(j)] = dict(
                plan=f["plan"], survivors=f["survivors"],
                counted=f["counted"], failed=f["failed"],
                dropped=f["dropped"], corrupt=f["corrupt"],
                ctx_available=ctx.available, ctx_counts=ctx.counts,
                ctx_times=ctx.expected_times)
        out = {"counts": self.counts, "inflight": inflight}
        if self.fault_engine is not None:
            out["faults"] = self.fault_engine.state_dict()
        return out

    def state_meta(self) -> dict:
        """JSON-serializable half (scalars, heap, RNG states)."""
        inflight = {}
        for j, f in sorted(self._in_flight.items()):
            ctx = f["ctx"]
            inflight[str(j)] = dict(
                t_start=f["t_start"], cost=f["cost"],
                fairness=f["fairness"], round_time=f["round_time"],
                est_cost=(None if f["est_cost"] is None
                          else float(f["est_cost"])),
                degraded=bool(f["degraded"]),
                rung=f.get("rung"),
                decision_ms=(None if f.get("decision_ms") is None
                             else float(f["decision_ms"])),
                ctx_round_idx=int(ctx.round_idx), ctx_tau=float(ctx.tau),
                ctx_n_sel=int(ctx.n_sel),
                ctx_other_costs=float(ctx.other_costs))
        return dict(
            clock=self.clock, seq=self._seq,
            retry_counts={str(j): int(c)
                          for j, c in sorted(self._retry_counts.items())},
            heap=[[float(t), int(s), k, int(j)] for t, s, k, j in self._heap],
            clamp_warned=sorted(self._clamp_warned),
            n_sel=self.n_sel, over_provision=self.over_provision,
            rng=self.rng.bit_generator.state,
            jobs=[dict(round_idx=js.round_idx, done=js.done,
                       reached_target_at=js.reached_target_at,
                       total_round_time=js.total_round_time,
                       admitted_at=js.admitted_at, retired=js.retired,
                       retired_at=js.retired_at, launched=js.launched,
                       parked=js.parked) for js in self.jobs],
            inflight=inflight)

    def load_state(self, arrays: dict, meta: dict) -> None:
        """Restore ``state_arrays``/``state_meta`` (jobs must already be
        re-added so every per-job row exists)."""
        self.counts = np.asarray(arrays["counts"], dtype=np.float64).copy()
        if self.fault_engine is not None and "faults" in arrays:
            self.fault_engine.load_state_dict(arrays["faults"])
        self.clock = float(meta["clock"])
        self._seq = int(meta["seq"])
        self._heap = [(float(t), int(s), str(k), int(j))
                      for t, s, k, j in meta["heap"]]
        heapq.heapify(self._heap)
        self._clamp_warned = set(meta["clamp_warned"])
        self._retry_counts = {int(j): int(c) for j, c
                              in meta.get("retry_counts", {}).items()}
        self.n_sel = int(meta["n_sel"])
        self.over_provision = float(meta["over_provision"])
        self.rng.bit_generator.state = meta["rng"]
        if len(meta["jobs"]) != len(self.jobs):
            raise ValueError(
                f"checkpoint has {len(meta['jobs'])} jobs, engine has "
                f"{len(self.jobs)} — re-add admitted jobs before load_state")
        for js, jm in zip(self.jobs, meta["jobs"]):
            js.round_idx = int(jm["round_idx"])
            js.done = bool(jm["done"])
            js.reached_target_at = jm["reached_target_at"]
            js.total_round_time = float(jm["total_round_time"])
            js.admitted_at = float(jm["admitted_at"])
            js.retired = bool(jm["retired"])
            js.retired_at = jm["retired_at"]
            js.launched = bool(jm["launched"])
            js.parked = bool(jm["parked"])
        self._in_flight = {}
        for key, fa in arrays["inflight"].items():
            fm = meta["inflight"][key]
            job = int(key)
            ctx = SchedulingContext(
                job=job, round_idx=int(fm["ctx_round_idx"]),
                tau=float(fm["ctx_tau"]), n_sel=int(fm["ctx_n_sel"]),
                available=np.asarray(fa["ctx_available"], dtype=bool),
                counts=np.asarray(fa["ctx_counts"], dtype=np.float64),
                expected_times=np.asarray(fa["ctx_times"], dtype=np.float64),
                other_costs=float(fm["ctx_other_costs"]))
            self._in_flight[job] = dict(
                plan=np.asarray(fa["plan"], dtype=bool),
                survivors=np.asarray(fa["survivors"], dtype=int),
                counted=np.asarray(fa["counted"], dtype=int),
                failed=np.asarray(fa["failed"], dtype=int),
                dropped=np.asarray(fa["dropped"], dtype=int),
                corrupt=np.asarray(fa["corrupt"], dtype=int),
                degraded=bool(fm["degraded"]),
                t_start=float(fm["t_start"]), cost=float(fm["cost"]),
                fairness=float(fm["fairness"]),
                round_time=float(fm["round_time"]),
                est_cost=fm["est_cost"], rung=fm.get("rung"),
                decision_ms=fm.get("decision_ms"), ctx=ctx)
