"""BODS's decisions made again in plain NumPy, to judge the plans a run
launched (paper Algorithm 1, lines 1-7, in the form the program's fused
acquisition states it).

Per job, a ring of observed plans (features, realized cost, estimated
cost); per decision, 256 candidates drawn from one seed that the
scheduler's NumPy generator gives: a quarter uniform Gumbel top-k, the
rest Gumbel top-k under random time and fairness weights, the first 32
replaced by mutations of the best observed plan repaired onto the free
devices. A Matern-5/2 GP over the features models the realized cost less
the estimate; each candidate's Expected Improvement against the least
posterior mean picks the plan.

The candidate draws follow the program's counter-based hash, bit for bit,
and their keys are formed in float32 as the program forms them, so the
candidate set is the program's; the features, the GP and the EI are
computed here in float64. A launched plan is judged by its regret: the
share of the best candidate's EI that the plan's own EI falls short by.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np

F32 = np.float32
M32 = 0xFFFFFFFF
MIX1, MIX2 = 0x7FEB352D, 0x2C1B3C6D
GOLD = 0x61C88647
WEIGHTS, GUMBEL, REPAIR = 1, 3, 4
MAX_OBS = 256
NUM_FEATURES = 6


@dataclasses.dataclass(frozen=True)
class Settings:
    """BODS's knobs as the traffic file states them."""

    candidates: int = 256
    init_points: int = 16
    gp_noise: float = 0.25

    @property
    def mutants(self) -> int:
        return min(32, self.candidates // 4)


def _mix(x):
    """The 32-bit mixer on a Python int or an int64 array below 2^32."""
    x = x & M32
    x = x ^ (x >> 16)
    x = (x * MIX1) & M32
    x = x ^ (x >> 15)
    x = (x * MIX2) & M32
    return x ^ (x >> 16)


def hash_uniform(seed: int, stream: int, ids: np.ndarray, width: int
                 ) -> np.ndarray:
    """(B, width) float32 U(0, 1): element k of row i a pure function of
    (seed, stream, ids[i], k); the top 24 of 32 mixed bits, plus a half,
    over 2^24."""
    key = _mix(_mix(int(seed)) ^ ((stream * GOLD) & M32))
    rows = _mix((np.asarray(ids, np.int64) * GOLD + key) & M32)
    cols = np.arange(width, dtype=np.int64) * GOLD
    bits = _mix((rows[:, None] + cols[None, :]) & M32) >> 8
    return ((bits.astype(F32) + F32(0.5)) * F32(1.0 / (1 << 24))).astype(F32)


def _norm01(x: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """[0, 1] by the spread over ``mask``, in x's precision; flat -> 0."""
    lo, hi = x[mask].min(), x[mask].max()
    spread = hi - lo
    if not np.isfinite(spread) or spread < 1e-9:
        return np.zeros_like(x)
    return np.clip((x - lo) / spread, 0, 1).astype(x.dtype)


def _topk(keys: np.ndarray, n_sel: int) -> np.ndarray:
    """(P, K) keys -> (P, K) bool plans of each row's n_sel largest."""
    idx = np.argpartition(-keys, n_sel - 1, axis=1)[:, :n_sel]
    plans = np.zeros(keys.shape, dtype=bool)
    np.put_along_axis(plans, idx, True, axis=1)
    return plans


def _repair(u: np.ndarray, plans: np.ndarray, avail: np.ndarray,
            n_sel: int) -> np.ndarray:
    keys = (plans & avail[None, :]).astype(F32) + u
    keys = np.where(avail[None, :], keys, -np.inf)
    return _topk(keys, n_sel)


def candidates(seed: int, times32: np.ndarray, counts: np.ndarray,
               avail: np.ndarray, mutants: np.ndarray, n_sel: int,
               count: int) -> np.ndarray:
    """The decision's (count, K) candidate plans."""
    K = times32.shape[0]
    ids = np.arange(count, dtype=np.int64)
    counts_c = (counts - float(np.mean(counts))).astype(F32)
    t_norm = _norm01(times32.astype(F32), avail)
    c_norm = _norm01(counts_c, np.ones(K, dtype=bool))
    w = hash_uniform(seed, WEIGHTS, ids, 2)
    w_time, w_fair = w[:, :1] * F32(6.0), w[:, 1:] * F32(4.0)
    logits = np.where((ids >= count // 4)[:, None],
                      (-w_time) * t_norm[None, :] - w_fair * c_norm[None, :],
                      F32(0.0)).astype(F32)
    with np.errstate(divide="ignore"):
        # A draw that rounds to 1 in float32 gives +inf, as the program's.
        g = -np.log(-np.log(hash_uniform(seed, GUMBEL, ids, K)))
    keys = np.where(avail[None, :], logits + g, -np.inf)
    plans = _topk(keys, n_sel)
    m = mutants.shape[0]
    if m:
        plans[:m] = _repair(hash_uniform(seed, REPAIR, ids[:m], K), mutants,
                            avail, n_sel)
    return plans


def mutate(rng: np.random.Generator, base: np.ndarray, n_mut: int
           ) -> np.ndarray:
    """``n_mut`` copies of ``base``, each with 1-3 selected-for-unselected
    swaps drawn from ``rng`` (the swaps of one copy are drawn from its
    selection before any of them is made)."""
    out = np.broadcast_to(base, (n_mut, base.shape[0])).copy()
    for i in range(n_mut):
        flips = rng.integers(1, 4)
        on, off = np.flatnonzero(out[i]), np.flatnonzero(~out[i])
        for _ in range(flips):
            if on.size and off.size:
                out[i][rng.choice(on)] = False
                out[i][rng.choice(off)] = True
    return out


def random_plans(rng: np.random.Generator, avail: np.ndarray, n_sel: int,
                 count: int) -> np.ndarray:
    """``count`` uniform n_sel-subsets of the free devices."""
    avail_idx = np.flatnonzero(avail)
    keys = rng.random((count, avail_idx.size))
    sel = np.argpartition(keys, n_sel - 1, axis=1)[:, :n_sel]
    plans = np.zeros((count, avail.shape[0]), dtype=bool)
    np.put_along_axis(plans, avail_idx[sel], True, axis=1)
    return plans


@dataclasses.dataclass
class Context:
    """One decision's inputs: the job's free devices, its counts (Formula
    16) and its expected times (Formula 4 plus any remaining busy time)."""

    job: int
    available: np.ndarray
    counts: np.ndarray
    times: np.ndarray
    n_sel: int


class Replay:
    """The scheduler's state, advanced by the plans a run launched."""

    def __init__(self, num_jobs: int, num_devices: int, mu: np.ndarray,
                 seed: int, alpha: float, beta: float, time_scale: float,
                 fairness_scale: float, settings: Settings = Settings()):
        self.rng = np.random.default_rng(seed)
        self.mu = np.asarray(mu, np.float64)
        self.alpha, self.beta = float(alpha), float(beta)
        self.ts, self.fs = float(time_scale), float(fairness_scale)
        self.s = settings
        M, K = num_jobs, num_devices
        self.F = np.zeros((M, MAX_OBS, NUM_FEATURES), F32)
        self.plans = np.zeros((M, MAX_OBS, K), bool)
        self.y = np.zeros((M, MAX_OBS), F32)
        self.est = np.zeros((M, MAX_OBS), F32)
        self.valid = np.zeros((M, MAX_OBS), F32)
        self.head = np.zeros(M, int)
        self.started = np.zeros(M, bool)

    # ---- Formula 2 and the plan's features, float64 ----

    def _terms(self, ctx: Context, plans: np.ndarray):
        t = np.where(plans, ctx.times[None, :], 0.0)
        n = plans.sum(1).astype(np.float64)
        c = ctx.counts.astype(np.float64)
        dfair = np.var(c[None, :] + plans, axis=1) - np.var(c)
        return t, n, dfair

    def own_cost(self, ctx: Context, plans: np.ndarray) -> np.ndarray:
        t, _, dfair = self._terms(ctx, plans)
        return self.alpha * t.max(1) / self.ts + self.beta * dfair / self.fs

    def features(self, ctx: Context, plans: np.ndarray) -> np.ndarray:
        t, n, dfair = self._terms(ctx, plans)
        jitter = np.where(plans, (ctx.times / np.maximum(self.mu, 1e-9))
                          [None, :], 0.0).max(1)
        novelty = (plans & (ctx.counts == 0)[None, :]).sum(1)
        return np.stack([t.max(1) / self.ts, dfair / self.fs,
                         t.sum(1) / np.maximum(n, 1) / self.ts,
                         jitter / self.ts, novelty / max(ctx.n_sel, 1),
                         n / plans.shape[1]], axis=1)

    def _push(self, job, plan, feat, cost, est):
        h = self.head[job] % MAX_OBS
        self.plans[job, h], self.F[job, h] = plan, feat
        self.y[job, h], self.est[job, h] = cost, est
        self.valid[job, h] = 1.0
        self.head[job] += 1

    # ---- the decision ----

    def decide(self, ctx: Context):
        """Advance the scheduler's generator through one decision: (the
        (P, K) candidates, ``ei(plans)``: the EI of any plans against the
        candidates' least posterior mean)."""
        j, s = ctx.job, self.s
        avail = np.asarray(ctx.available, bool)
        if not self.started[j]:
            boot = random_plans(self.rng, avail, ctx.n_sel, s.init_points)
            costs = self.own_cost(ctx, boot)
            for p, f, c in zip(boot, self.features(ctx, boot), costs):
                self._push(j, p, f.astype(F32), F32(c), F32(c))
            self.started[j] = True
        y, valid = self.y[j], self.valid[j]
        sd = float(y[valid > 0].std()) + 1e-6 if valid.sum() else 1.0
        best_i = int(np.argmin(np.where(valid > 0, y, np.inf)))
        muts = mutate(self.rng, self.plans[j, best_i], s.mutants)
        seed = int(self.rng.integers(0, 2 ** 31 - 1))
        cands = candidates(seed, ctx.times.astype(F32), ctx.counts, avail,
                           muts, ctx.n_sel, s.candidates)
        model = self._model(j, sd)
        incumbent = float(self._posterior(model, ctx, cands)[0].min())

        def ei(plans):
            return _ei(*self._posterior(model, ctx, plans), incumbent)
        return cands, ei

    def choose(self, ctx: Context) -> np.ndarray:
        """BODS's plan: the candidate of the best EI (the first of equals)."""
        cands, ei = self.decide(ctx)
        return cands[int(np.argmax(ei(cands)))]

    def regret(self, ctx: Context, plan: np.ndarray) -> float:
        """One decision, and the launched ``plan``'s regret: (the best
        candidate's EI less the plan's) over the best candidate's EI, 0
        where the plan does at least as well."""
        cands, ei = self.decide(ctx)
        top = float(ei(cands).max())
        own = float(ei(np.asarray(plan, bool)[None, :])[0])
        return max(0.0, (top - own) / top) if top > 0 else 0.0

    def observe(self, ctx: Context, plan: np.ndarray, cost: float) -> None:
        """The launched plan and its realized cost join the job's ring."""
        plan = np.asarray(plan, bool)[None, :]
        self._push(ctx.job, plan[0], self.features(ctx, plan)[0].astype(F32),
                   F32(cost), F32(self.own_cost(ctx, plan)[0]))

    def _model(self, j: int, sd: float):
        """The GP over job ``j``'s ring: (features, Cholesky factor, dual
        weights, mask)."""
        F = self.F[j].astype(np.float64)
        m = self.valid[j].astype(np.float64)
        resid = (self.y[j].astype(np.float64) - self.est[j]) / sd * m
        mm = m[:, None] * m[None, :]
        L = F.shape[0]
        K_nn = _matern52(_sq(F, F)) * mm + (1.0 - mm) * np.eye(L)
        K_nn += (self.s.gp_noise + 1e-6) * np.eye(L)
        chol = np.linalg.cholesky(K_nn)
        w = np.linalg.solve(chol.T, np.linalg.solve(chol, resid))
        return F, chol, w, m, sd

    def _posterior(self, model, ctx: Context, plans: np.ndarray):
        """(mean, stddev) of ``plans`` under ``model``; the prior mean is
        the plan's estimated cost."""
        F, chol, w, m, sd = model
        K_nc = _matern52(_sq(F, self.features(ctx, plans))) * m[:, None]
        mu_c = self.own_cost(ctx, plans) / sd + K_nc.T @ w
        v = np.linalg.solve(chol, K_nc)
        return mu_c, np.sqrt(np.maximum(1.0 - (v * v).sum(0), 1e-9))


def _sq(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)


def _matern52(sq: np.ndarray) -> np.ndarray:
    r = np.sqrt(np.maximum(sq, 1e-12))
    return (1.0 + math.sqrt(5.0) * r + 5.0 * sq / 3.0) * np.exp(
        -math.sqrt(5.0) * r)


def _ei(mu: np.ndarray, sigma: np.ndarray, best: float) -> np.ndarray:
    z = (best - mu) / sigma
    cdf = 0.5 * np.vectorize(math.erfc)(-z / math.sqrt(2.0))
    pdf = np.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)
    return (best - mu) * cdf + sigma * pdf


def settings_of(traffic: Dict) -> Optional[Settings]:
    """The traffic's BODS settings, or None where it schedules otherwise."""
    if traffic.get("scheduler") != "bods":
        return None
    b = traffic["bods"]
    return Settings(candidates=int(b["candidates"]),
                    init_points=int(b["init_points"]),
                    gp_noise=float(b["gp_noise"]))
