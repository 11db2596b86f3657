"""SLO-driven serve resilience: the degradation ladder, circuit breakers,
and the stalled-round watchdog (the ``slo`` spec axis' runtime).

``attach_resilience(engine, slo)`` hangs a ``DecisionGovernor`` on a built
``MultiJobEngine`` and configures its bounded-retry knobs. From then on
every scheduling decision flows through ``DecisionGovernor.decide``, which
picks a rung of the degradation ladder

    full         — the live scheduler's complete plan search (rung 0)
    incremental  — repair the job's cached last-good plan for current
                   availability, score it against a greedy candidate
                   through the batched scoring core, keep the cheaper
    greedy       — fastest-n_sel closed form (one argpartition)
    last_good    — the repaired cached plan, unscored (floor latency)

under two independent pressures:

- **queue pressure** (deterministic): the service mirrors its admission
  queue depth into ``governor.queue_depth``; depth in the upper half of
  ``max_queue_depth`` degrades one rung, beyond it two. Pure function of
  simulated state — crash/resume replays it bit-identically.
- **latency pressure** (wall clock): when ``decision_deadline_ms`` is set,
  each rung's recent worst-case latency (a bounded window) must fit within
  the safety-scaled budget; the best rung that fits wins, and every
  ``rung_probe_every`` forced degradations the next-better rung gets one
  probe decision so recoveries are discovered.

The governor caches each job's chosen plan (by device index) as its
last-good plan after every decision, so rungs 1/3 always have a repair
base after the first round; without one they fall through to greedy.

``CircuitBreaker``/``BreakerBoard`` implement closed -> open -> half-open
breakers on SIMULATED time: per-tenant (opened by consecutive degraded or
fault-heavy rounds; open sheds that tenant's arrivals) and per-fault-domain
(opened by consecutive rounds where the domain's scheduled members mostly
failed; open masks the domain's devices out of ``ctx.available`` whenever
enough devices remain). Board state is JSON and rides in the service
checkpoint, so breakers survive ``kill -9`` resume.

``RoundWatchdog`` checks the engine's liveness invariant — every launched,
unfinished job must own an in-flight round or a pending heap event — and
reports jobs that stay wedged for N consecutive checks; the service
responds by restoring from the newest committed checkpoint.

Determinism: wall-clock latency samples are deliberately NOT persisted
(they are not replayable); everything else — last-good plans, rung/shed
counters, breaker and watchdog state — is.
"""

from __future__ import annotations

import time
import warnings
from collections import deque
from typing import Dict, List, Optional

import numpy as np

RUNGS = ("full", "incremental", "greedy", "last_good")


# ---------------------------------------------------------------------------
# circuit breakers
# ---------------------------------------------------------------------------

class CircuitBreaker:
    """Consecutive-failure breaker on simulated time.

    closed -> (threshold consecutive failures) -> open -> (cooldown elapses)
    -> half-open, where ``allow`` grants exactly one probe; the probe's
    outcome (``record``) either closes the breaker or re-opens it for
    another cooldown. A probe whose outcome never arrives (e.g. a masked
    domain that no plan happened to exercise) re-arms after a further
    cooldown so the breaker cannot wedge half-open.
    """

    def __init__(self, threshold: int, cooldown: float):
        self.threshold = int(threshold)
        self.cooldown = float(cooldown)
        self.state = "closed"
        self.failures = 0          # consecutive, while closed
        self.opened_at: Optional[float] = None
        self.probing = False
        self.probe_at: Optional[float] = None
        self.trips = 0

    def allow(self, now: float) -> bool:
        """May the guarded party participate at simulated instant ``now``?
        (Transitions open -> half-open and arms the single probe.)"""
        if self.state == "closed":
            return True
        if self.state == "open":
            if now - self.opened_at >= self.cooldown:
                self.state = "half_open"
                self.probing = True
                self.probe_at = now
                return True
            return False
        # half-open: one probe outstanding; re-arm if its outcome never came.
        if self.probing and now - self.probe_at >= self.cooldown:
            self.probe_at = now
            return True
        if not self.probing:
            self.probing = True
            self.probe_at = now
            return True
        return False

    def record(self, ok: bool, now: float) -> Optional[str]:
        """Feed one outcome; returns the new state iff it changed."""
        if self.state == "half_open":
            self.probing = False
            if ok:
                self.state = "closed"
                self.failures = 0
                return "closed"
            self.state = "open"
            self.opened_at = now
            self.trips += 1
            return "open"
        if ok:
            self.failures = 0
            return None
        self.failures += 1
        if self.state == "closed" and self.failures >= self.threshold:
            self.state = "open"
            self.opened_at = now
            self.trips += 1
            return "open"
        return None

    def state_dict(self) -> dict:
        return dict(state=self.state, failures=self.failures,
                    opened_at=self.opened_at, probing=self.probing,
                    probe_at=self.probe_at, trips=self.trips)

    def load_state_dict(self, d: dict) -> None:
        self.state = str(d["state"])
        self.failures = int(d["failures"])
        self.opened_at = d["opened_at"]
        self.probing = bool(d["probing"])
        self.probe_at = d["probe_at"]
        self.trips = int(d["trips"])


class BreakerBoard:
    """Per-tenant and per-fault-domain breaker registries (lazy-created)."""

    def __init__(self, threshold: int, cooldown: float):
        self.threshold = int(threshold)
        self.cooldown = float(cooldown)
        self.tenants: Dict[str, CircuitBreaker] = {}
        self.domains: Dict[int, CircuitBreaker] = {}

    def tenant(self, name: str) -> CircuitBreaker:
        br = self.tenants.get(name)
        if br is None:
            br = self.tenants[name] = CircuitBreaker(self.threshold,
                                                     self.cooldown)
        return br

    def domain(self, d: int) -> CircuitBreaker:
        br = self.domains.get(d)
        if br is None:
            br = self.domains[d] = CircuitBreaker(self.threshold,
                                                  self.cooldown)
        return br

    @property
    def trips(self) -> int:
        return (sum(b.trips for b in self.tenants.values())
                + sum(b.trips for b in self.domains.values()))

    def open_counts(self) -> dict:
        return dict(
            tenants_open=sum(1 for b in self.tenants.values()
                             if b.state != "closed"),
            domains_open=sum(1 for b in self.domains.values()
                             if b.state != "closed"),
            trips=self.trips)

    def state_dict(self) -> dict:
        return {
            "tenants": {t: b.state_dict()
                        for t, b in sorted(self.tenants.items())},
            "domains": {str(d): b.state_dict()
                        for d, b in sorted(self.domains.items())},
        }

    def load_state_dict(self, d: dict) -> None:
        self.tenants = {}
        for t, bd in d["tenants"].items():
            self.tenant(t).load_state_dict(bd)
        self.domains = {}
        for k, bd in d["domains"].items():
            self.domain(int(k)).load_state_dict(bd)


# ---------------------------------------------------------------------------
# the decision governor (degradation ladder)
# ---------------------------------------------------------------------------

class DecisionGovernor:
    """Wraps ``scheduler.schedule`` in the SLO's latency budget.

    ``decide`` returns ``(plan, rung, decision_ms, est_cost)`` where
    ``decision_ms`` is None unless a wall-clock deadline is active (so
    records stay replayable in the deterministic modes) and ``est_cost``
    is the rung's own Formula-2 estimate of its chosen plan (None for the
    unscored last-good rung).
    """

    def __init__(self, slo, cost_model, clock=time.perf_counter):
        self.slo = slo
        self.cost_model = cost_model
        self.clock = clock  # injectable for deterministic tests
        self.engine = None  # set by attach_resilience (event publishing)
        self.fault_domain: Optional[np.ndarray] = None  # (K,) device->domain
        self.breakers: Optional[BreakerBoard] = (
            BreakerBoard(slo.breaker_threshold, slo.breaker_cooldown)
            if slo.breaker_threshold > 0 else None)
        # Queue pressure input, mirrored by the service from its admission
        # queue; stays 0 for offline (non-serve) engines.
        self.queue_depth = 0
        self._last_good: Dict[int, np.ndarray] = {}   # job -> (n_sel,) idx
        # Rolling worst-case latency estimate per rung (ms), plus full
        # sample lists for the report's rung-level p50/p99.
        self._lat = {r: deque(maxlen=slo.latency_window) for r in RUNGS}
        # Chronological window across ALL rungs — the admission-control
        # rolling-p99 input.
        self.recent_ms = deque(maxlen=slo.latency_window)
        self.rung_samples: Dict[str, List[float]] = {r: [] for r in RUNGS}
        self.rung_counts: Dict[str, int] = {r: 0 for r in RUNGS}
        self.deadline_misses = 0
        self._forced = 0          # latency-forced degradations (probe clock)
        # Bench hook: keep (ctx, chosen idx, rung, est) per decision.
        self.keep_decisions = False
        self.decision_log: List[dict] = []

    # ---- rung selection ----

    def _queue_rung(self) -> int:
        q = self.slo.max_queue_depth
        if q is None or q <= 0:
            return 0
        if self.queue_depth <= q // 2:
            return 0
        if self.queue_depth <= q:
            return 1
        return 2

    def _latency_rung(self) -> int:
        ddl = self.slo.decision_deadline_ms
        if ddl is None:
            return 0
        budget = ddl * self.slo.deadline_safety
        for i, r in enumerate(RUNGS):
            est = max(self._lat[r]) if self._lat[r] else 0.0
            if est <= budget:
                if i > 0:
                    self._forced += 1
                    if self._forced % self.slo.rung_probe_every == 0:
                        return i - 1   # periodic probe of the better rung
                return i
        return len(RUNGS) - 1

    # ---- domain-breaker availability masking ----

    def _mask_domains(self, ctx, now: float) -> None:
        if self.breakers is None or self.fault_domain is None:
            return
        blocked = [d for d, br in sorted(self.breakers.domains.items())
                   if not br.allow(now)]
        if not blocked:
            return
        keep = ctx.available & ~np.isin(self.fault_domain, blocked)
        # Never starve the decision: masking must leave a full cohort.
        if int(np.count_nonzero(keep)) >= ctx.n_sel:
            ctx.available = keep
            ctx._avail_idx = None  # invalidate the context's id cache

    # ---- rung executors ----

    def _greedy_idx(self, ctx) -> np.ndarray:
        avail = ctx.available_indices()
        if avail.size <= ctx.n_sel:
            return avail.copy()
        t_av = ctx.expected_times[avail]
        cut = np.argpartition(t_av, ctx.n_sel - 1)[: ctx.n_sel]
        return np.sort(avail[cut])

    def _repair(self, cached: np.ndarray, ctx) -> np.ndarray:
        """Fit a cached plan to the current world: drop unavailable
        members, trim to n_sel keeping the fastest, fill shortfalls with
        the fastest available non-members."""
        keep = cached[ctx.available[cached]]
        if keep.size > ctx.n_sel:
            order = np.argsort(ctx.expected_times[keep], kind="stable")
            keep = keep[order[: ctx.n_sel]]
        elif keep.size < ctx.n_sel:
            avail = ctx.available_indices()
            extra = np.setdiff1d(avail, keep, assume_unique=False)
            need = min(ctx.n_sel - keep.size, extra.size)
            if need > 0:
                order = np.argsort(ctx.expected_times[extra], kind="stable")
                keep = np.concatenate([keep, extra[order[:need]]])
        return np.sort(keep)

    def _execute(self, rung: int, scheduler, ctx):
        """Run one rung; returns (idx, est_cost, plan_or_None)."""
        if rung == 0:
            plan = scheduler.schedule(ctx)
            est = scheduler.last_estimated_cost
            return np.flatnonzero(plan), (
                None if est is None else float(est)), plan
        if rung == 1:
            cand = np.stack([self._repair(self._last_good[ctx.job], ctx),
                             self._greedy_idx(ctx)])
            costs = np.asarray(self.cost_model.cost_indices(
                ctx.expected_times, ctx.counts, cand))
            best = int(np.argmin(costs))
            return cand[best], float(costs[best]), None
        if rung == 2:
            idx = self._greedy_idx(ctx)
            cost = self.cost_model.cost_indices(
                ctx.expected_times, ctx.counts, idx[None])
            return idx, float(np.asarray(cost)[0]), None
        return self._repair(self._last_good[ctx.job], ctx), None, None

    # ---- the decision ----

    def decide(self, scheduler, ctx, now: float):
        self._mask_domains(ctx, now)
        rung = max(self._queue_rung(), self._latency_rung())
        # The repair rungs need a cached base; before the job's first
        # decision they fall through to greedy (still bounded latency).
        if rung in (1, 3) and ctx.job not in self._last_good:
            rung = 2
        t0 = self.clock()
        idx, est, plan = self._execute(rung, scheduler, ctx)
        ms = (self.clock() - t0) * 1e3
        if plan is None:
            plan = np.zeros(ctx.available.shape[0], dtype=bool)
            plan[idx] = True
        name = RUNGS[rung]
        self._lat[name].append(ms)
        self.recent_ms.append(ms)
        self.rung_samples[name].append(ms)
        self.rung_counts[name] += 1
        ddl = self.slo.decision_deadline_ms
        if ddl is not None and ms > ddl:
            self.deadline_misses += 1
        self._last_good[ctx.job] = idx
        if self.keep_decisions:
            self.decision_log.append(dict(
                job=ctx.job, round_idx=ctx.round_idx, rung=name,
                ms=ms, est=est, idx=idx.copy(), ctx=ctx))
        if rung > 0 and self.engine is not None \
                and self.engine.events is not None:
            self.engine.events.publish("serve.degrade", dict(
                job=ctx.job, round_idx=ctx.round_idx, rung=name, t=now,
                decision_ms=(ms if ddl is not None else None),
                queue_depth=self.queue_depth))
        return plan, name, (ms if ddl is not None else None), est

    def rolling_p99(self) -> float:
        """p99 (ms) over the chronological recent-decision window — the
        service's admission-backpressure signal."""
        if not self.recent_ms:
            return 0.0
        return float(np.percentile(np.asarray(self.recent_ms), 99.0))

    # ---- breaker feedback (called by the service per finished round) ----

    def note_round(self, rec, tenant: Optional[str], now: float) -> List[dict]:
        """Feed one finished round's outcome to the breakers; returns the
        state transitions (for event publishing)."""
        if self.breakers is None:
            return []
        changes: List[dict] = []
        failed = np.asarray(rec.failed_ids, dtype=int)
        scheduled = len(rec.device_ids) + len(rec.dropped)
        frac = failed.size / max(scheduled, 1)
        if tenant is not None:
            bad = bool(rec.degraded) or frac >= self.slo.breaker_failure_frac
            tr = self.breakers.tenant(tenant).record(not bad, now)
            if tr is not None:
                changes.append(dict(kind="tenant", key=tenant, state=tr,
                                    t=now))
        if self.fault_domain is not None and scheduled > 0:
            part = np.concatenate([np.asarray(rec.device_ids, dtype=int),
                                   np.asarray(rec.dropped, dtype=int)])
            part_dom = self.fault_domain[part]
            fail_dom = self.fault_domain[failed] if failed.size else \
                np.array([], dtype=int)
            for d in np.unique(part_dom):
                n_part = int(np.count_nonzero(part_dom == d))
                n_fail = int(np.count_nonzero(fail_dom == d))
                bad = n_fail / n_part >= self.slo.breaker_failure_frac
                dr = self.breakers.domain(int(d)).record(not bad, now)
                if dr is not None:
                    changes.append(dict(kind="domain", key=int(d), state=dr,
                                        t=now))
        return changes

    # ---- persistence (wall-clock samples intentionally excluded) ----

    def state_dict(self) -> dict:
        return {
            "last_good": {str(j): idx.tolist()
                          for j, idx in sorted(self._last_good.items())},
            "rung_counts": dict(self.rung_counts),
            "deadline_misses": self.deadline_misses,
            "forced": self._forced,
            "breakers": (self.breakers.state_dict()
                         if self.breakers is not None else None),
        }

    def load_state_dict(self, d: dict) -> None:
        self._last_good = {int(j): np.asarray(v, dtype=int)
                           for j, v in d["last_good"].items()}
        self.rung_counts = {r: int(d["rung_counts"].get(r, 0))
                            for r in RUNGS}
        self.deadline_misses = int(d["deadline_misses"])
        self._forced = int(d["forced"])
        if self.breakers is not None and d.get("breakers") is not None:
            self.breakers.load_state_dict(d["breakers"])

    # ---- reporting ----

    def summary(self) -> dict:
        def pct(xs, q):
            return float(np.percentile(np.asarray(xs), q)) if xs else 0.0
        out = dict(
            rung_counts=dict(self.rung_counts),
            rung_latency_ms={r: dict(count=len(s), p50=pct(s, 50),
                                     p99=pct(s, 99))
                             for r, s in self.rung_samples.items() if s},
            deadline_misses=self.deadline_misses,
            degraded_decisions=sum(v for r, v in self.rung_counts.items()
                                   if r != "full"),
            decisions=sum(self.rung_counts.values()),
        )
        if self.breakers is not None:
            out["breakers"] = self.breakers.open_counts()
        return out


# ---------------------------------------------------------------------------
# stalled-round watchdog
# ---------------------------------------------------------------------------

class RoundWatchdog:
    """Liveness invariant: every launched, unfinished, unparked job owns an
    in-flight round or a pending heap event. ``check`` counts consecutive
    violations per job and reports the jobs at/over the threshold."""

    def __init__(self, threshold: int):
        self.threshold = int(threshold)
        self._stalls: Dict[int, int] = {}

    def check(self, engine) -> List[int]:
        pending = {j for (_, _, _, j) in engine._heap}
        wedged: List[int] = []
        for j, js in enumerate(engine.jobs):
            live = js.launched and not js.done and not js.parked
            if not live or j in engine._in_flight or j in pending:
                self._stalls.pop(j, None)
                continue
            c = self._stalls.get(j, 0) + 1
            self._stalls[j] = c
            if c >= self.threshold:
                wedged.append(j)
        return wedged

    def reset(self) -> None:
        self._stalls = {}

    def state_dict(self) -> dict:
        return {str(j): c for j, c in sorted(self._stalls.items())}

    def load_state_dict(self, d: dict) -> None:
        self._stalls = {int(j): int(c) for j, c in d.items()}


# ---------------------------------------------------------------------------
# wiring
# ---------------------------------------------------------------------------

def attach_resilience(engine, slo) -> Optional[DecisionGovernor]:
    """Configure a built engine for the SLO: hang a ``DecisionGovernor``
    (when any decision-path knob is active) and set the bounded-retry
    knobs. Called by ``ExperimentSpec.build`` when ``effective_slo()`` is
    non-None; an inert spec never reaches here."""
    engine.max_launch_retries = slo.max_launch_retries
    engine.retry_backoff = slo.retry_backoff
    engine.retry_base_delay = slo.retry_base_delay
    engine.max_agg_retries = slo.max_agg_retries
    needs_governor = (slo.decision_deadline_ms is not None
                      or slo.max_queue_depth is not None
                      or slo.breaker_threshold > 0)
    if not needs_governor:
        return None
    gov = DecisionGovernor(slo, engine.cost_model)
    gov.engine = engine
    if engine.fault_engine is not None:
        gov.fault_domain = engine.fault_engine.domain
    if slo.breaker_threshold > 0 and engine.fault_engine is None:
        warnings.warn("slo.breaker_threshold set without a faults axis: "
                      "domain breakers are inactive (no fault domains)",
                      RuntimeWarning)
    engine.governor = gov
    return gov
