"""Fused scheduler search: the plan-SEARCH loops on tensors on the device.

The host searchers step one proposal at a time through Python; here each
decision runs as one program of tensor operations on ``device`` (the card
unless the caller asks for the CPU):

- ``sa_search``    — C parallel simulated-annealing chains over plans in
  INDEX form ((C, n_sel) device ids, n_sel gathers a step instead of a
  K-wide sweep), swap/accept noise pre-drawn on the host from the
  scheduler's numpy ``rng`` (the loop draws nothing), masked
  one-selected-for-one-free swaps, geometric cooling, running per-chain
  best, best-of-chains result.
- ``ga_search``    — generations of an index-form population with
  host-drawn tournaments, slot-wise uniform crossover (a slot adopts the
  other parent's device only if this parent lacks it, so children stay
  duplicate-free and exactly n_sel-sized), swap mutation, elitism in slot 0.
- ``bods_acquire`` — the whole BODS acquisition: candidate generation
  (uniform and structured Gumbel top-k over availability logits, plus the
  host's local-search mutants of the best observed plan through the
  vectorized repair), featurization phi(V), the Matern-5/2 GP posterior,
  Expected Improvement and the argmax. The (P, K) candidate block lives on
  the device; its per-plan statistics come from the plan-scoring kernel
  (``kernels.ops.sched_plan_stats``, kernel 2.1) under the default impl.

Every noise array of SA and GA is drawn from the numpy ``rng`` in the
reference's order, so the same seed gives the reference's plans. The BODS
candidates are drawn on the device from a counter-based hash: every draw
(the weights w_time and w_fair, the Gumbel noise, the repair keys) is a
pure function of (decision seed, candidate id, element), with the seed one
``rng`` draw per decision (the reference draws the same integer for its
``jax.random`` key). A decision is then a function of the scheduler's seed
alone, and the candidate set does not depend on how the candidate axis is
split.

With ``num_shards`` > 1 each search splits its parallel axis over devices
(one block per CUDA device, or the ``devices=`` a caller names): SA its
chains, GA its population (each generation gathers the population and its
costs, so selection and elitism see the global state), BODS its candidates
(each block generates, featurizes (kernel 2.1 on the block's device) and
scores its own candidates; the incumbent is the least posterior mean over
all blocks, ties break to the lowest candidate id). The result is the
single lane's. Without enough devices, when the rows do not split, or when
a GA block is odd, a search falls back to one lane (``_usable_search_shards``,
logged and counted in ``fallbacks``), as the reference does.

Conventions (as in ``repro_torch.core.scoring``): times and counts are f32
on the device; counts are mean-centred in f64 on the host first; sums of
weights over a plan accumulate in f64 and round to f32 once, so the CPU
and the card agree bit for bit where no transcendental enters. Divisors
are device tensors, never Python floats: CUDA divides by a host scalar as
a multiply by its reciprocal, one bit off a true division. A decision
copies its inputs to each block's device in two transfers (from pinned
memory, not blocking the host) and reads back one result, its one
synchronisation; the loops never read the device.
"""

from __future__ import annotations

import logging
import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.plans import plan_from_indices
from repro_torch.core.scoring import DeviceLike, resolve_device
from repro_torch.monitoring.trace import span

F32 = torch.float32
F64 = torch.float64

logger = logging.getLogger(__name__)

#: Sharded searches that fell back to one lane since the last reset.
fallbacks = 0


def _usable_search_shards(num_shards, rows: int, pairs: bool = False,
                          device: DeviceLike = "cuda",
                          devices: Optional[Sequence] = None) -> int:
    """Shard count a fused search can use for ``rows`` parallel units (SA
    chains, GA population, BODS candidates): one lane when the process
    lacks the devices (``devices`` names them, else one card per shard is
    needed), when ``rows`` does not split evenly, or (``pairs``) when a
    block would break the GA's consecutive-pair crossover. Falling back
    changes nothing but the partitioning."""
    global fallbacks
    from repro_torch.core import shard

    n = int(num_shards or 1)
    if n <= 1:
        return 1
    reason = None
    if devices is None:
        if torch.device(device).type != "cuda":
            reason = f"device {str(device)!r} is not a card"
        elif n > shard.shard_capacity():
            reason = (f"num_shards={n} exceeds torch.cuda.device_count()="
                      f"{shard.shard_capacity()}")
    if reason is None and rows % n:
        reason = f"{rows} search rows do not split across {n} shards"
    if reason is None and pairs and (rows // n) % 2:
        reason = (f"per-shard block {rows // n} is odd (pair crossover "
                  "needs even blocks)")
    if reason is not None:
        logger.debug("fused search falling back to single lane: %s", reason)
        fallbacks += 1
        return 1
    return n


def _search_devices(n: int, device: DeviceLike,
                    devices: Optional[Sequence]) -> List[torch.device]:
    """The device of each of the ``n`` blocks of a fused search."""
    from repro_torch.core import shard

    if n == 1:
        return [resolve_device(device)]
    return shard.block_devices(n, "shard_map", device, devices)


# ---- host <-> device ------------------------------------------------------

def _to_device(device: torch.device, dtype, *arrays) -> list:
    """Host arrays (and scalars) as tensors of ``dtype`` on ``device``
    through ONE copy: concatenated flat on the host, split into views on
    the device (each view keeps its array's shape; a scalar is 0-dim). To
    a card the copy goes from pinned memory without blocking the host."""
    np_dtype = {F32: np.float32, torch.int64: np.int64,
                torch.bool: np.bool_}[dtype]
    parts = [np.asarray(a, dtype=np_dtype) for a in arrays]
    t = torch.from_numpy(np.concatenate([p.ravel() for p in parts]))
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    else:
        t = t.to(device)
    out, off = [], 0
    for p in parts:
        out.append(t[off:off + p.size].view(p.shape))
        off += p.size
    return out


# ---- building blocks on tensors -------------------------------------------

def _count_sums(counts_c: torch.Tensor):
    """(c1, c2, K, K*K) as f32 device scalars: the centred counts' sum and
    sum of squares, accumulated in f64 and rounded once (the reference sums
    in f32), and the divisors of the variance expansion."""
    c1 = counts_c.sum(dtype=F64).to(F32)
    c2 = (counts_c * counts_c).sum(dtype=F64).to(F32)
    K = float(counts_c.shape[-1])  # float: K*K overflows int32 at K=100k
    k, kk = (torch.full((), v, dtype=F32, device=counts_c.device)
             for v in (K, K * K))
    return c1, c2, k, kk


def _fairness_from_stats(counts_c, n, wsum, delta_fairness: bool,
                         sums=None):
    """Formula-5 fairness from the centred sufficient statistics (the one
    copy of the variance expansion here). ``n``: (P,) selected counts (or
    one float for the index form); ``wsum``: (P,) sums of 2*counts_c+1 over
    the selection; ``sums``: ``_count_sums(counts_c)`` when hoisted."""
    c1, c2, k, kk = _count_sums(counts_c) if sums is None else sums
    if delta_fairness:
        return wsum / k - (2.0 * c1 * n + n * n) / kk
    return (c2 + wsum) / k - ((c1 + n) / k) ** 2


def _as_f32(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=F32)
    return torch.full((), float(np.float32(x)), dtype=F32, device=device)


def _dense_stats(times, counts_c, plans):
    """(P, K) bool plans -> (round time t, n selected, wsum), from the
    plan-scoring kernel's three statistics (``ops.sched_plan_stats`` under
    the default impl: the kernel on CUDA tensors, its plain version on CPU
    ones). The kernel gives -1e30 for an empty plan; t is 0 there, as in
    the reference's masked max."""
    from repro_torch.kernels import ops

    w = 2.0 * counts_c + 1.0
    stats = ops.sched_plan_stats(times.contiguous(), w, plans.contiguous(),
                                 impl=ops.get_default_impl())
    t, n, wsum = stats.unbind(1)
    t = torch.where((n > 0) & torch.isfinite(t), t, 0.0)
    return t, n, wsum


def plan_costs(times, counts_c, plans, alpha, beta, ts, fs,
               delta_fairness: bool):
    """(P, K) bool plans -> (P,) Formula-2 costs (``counts_c`` centred)."""
    dev = plans.device
    t, n, wsum = _dense_stats(times, counts_c, plans)
    f = _fairness_from_stats(counts_c, n, wsum, delta_fairness)
    return (_as_f32(alpha, dev) * t / _as_f32(ts, dev)
            + _as_f32(beta, dev) * f / _as_f32(fs, dev))


def _idx_cost_fn(times, counts_c, alpha, beta, ts, fs, delta_fairness):
    """The index-form cost of one decision, its constants hoisted: returns
    ``cost(idx)`` for (P, n_sel) device-id plans with distinct rows."""
    dev = times.device
    w = 2.0 * counts_c + 1.0
    sums = _count_sums(counts_c)
    alpha, beta, ts, fs = (_as_f32(x, dev) for x in (alpha, beta, ts, fs))

    def cost(idx):
        n = float(idx.shape[-1])
        t = times[idx].amax(dim=-1)
        wsum = w[idx].sum(dim=-1, dtype=F64).to(F32)
        f = _fairness_from_stats(counts_c, n, wsum, delta_fairness, sums)
        return alpha * t / ts + beta * f / fs

    return cost


def plan_costs_idx(times, counts_c, idx, alpha, beta, ts, fs,
                   delta_fairness: bool):
    """(P, n_sel) device-id plans -> (P,) Formula-2 costs (n_sel gathers a
    plan, never a K-wide sweep). Rows must hold distinct ids."""
    return _idx_cost_fn(times, counts_c, alpha, beta, ts, fs,
                        delta_fairness)(idx)


def _topk_plans(keys, n_sel: int, avail):
    """Rows of ``keys`` -> (P, K) bool plans of their n_sel largest, within
    ``avail``. Unavailable keys must be -inf and at least n_sel finite keys
    a row (``_check_avail``), so no tie decides a selection."""
    _, idx = torch.topk(keys, n_sel, dim=1)
    plans = torch.zeros(keys.shape, dtype=torch.bool, device=keys.device)
    plans.scatter_(1, idx, True)
    return plans & avail[None, :]


def _uniform(gen, shape, device):
    # U(tiny, 1), as jax.random draws for its Gumbel noise: never log(0).
    u = torch.rand(shape, generator=gen, device=device, dtype=F32)
    return u.clamp_(min=torch.finfo(F32).tiny)


def _repair_with(u, plans, avail, n_sel: int):
    """``repair_plans_torch`` on given (P, K) U(0, 1) noise ``u``."""
    keys = (plans & avail[None, :]).to(F32) + u
    keys = torch.where(avail[None, :], keys, -torch.inf)
    return _topk_plans(keys, n_sel, avail)


def repair_plans_torch(gen, plans, avail, n_sel: int):
    """Vectorized repair on the device: the twin of the reference's
    ``search.repair_plans_jax`` and of the host ``plans.repair_plans``.

    Priority top-k: valid selections keep rank over everything else (key
    1 + noise vs noise), occupied devices are masked out, noise tie-breaks
    pick the random extras to drop / random available devices to add.
    Idempotent on valid plans. Precondition: ``avail.sum() >= n_sel``.
    """
    return _repair_with(_uniform(gen, plans.shape, plans.device), plans,
                        avail, n_sel)


# ---- counter-based draws --------------------------------------------------
#
# The BODS candidates' noise, as a pure function of (seed, stream, candidate
# id, element): a 32-bit state mixed by two multiply-xorshift rounds
# (constants below 2^31, so every product of a 32-bit state stays below
# 2^63 in int64, masked back to 32 bits after each step). The CPU and the
# card compute the same integers, bit for bit.

_M32 = 0xFFFFFFFF
_MIX1, _MIX2 = 0x7FEB352D, 0x2C1B3C6D
_GOLD = 0x61C88647        # 2^32 - 0x9E3779B9: the golden-ratio step

# Streams of one decision's draws (the weights are elements 0 and 1 of
# one stream).
_WEIGHTS, _GUMBEL, _REPAIR = 1, 3, 4


def _mix32_int(x: int) -> int:
    """``_mix32`` on a Python integer."""
    x &= _M32
    x ^= x >> 16
    x = (x * _MIX1) & _M32
    x ^= x >> 15
    x = (x * _MIX2) & _M32
    return x ^ (x >> 16)


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """The 32-bit mixer on an int64 tensor of values in [0, 2^32), in
    place."""
    x ^= x >> 16
    x.mul_(_MIX1).bitwise_and_(_M32)
    x ^= x >> 15
    x.mul_(_MIX2).bitwise_and_(_M32)
    x ^= x >> 16
    return x


def hash_bits(seed: int, stream: int, ids: torch.Tensor,
              width: int) -> torch.Tensor:
    """(B, width) int64 32-bit draws for the (B,) int64 candidate ``ids``:
    element k of row i is a pure function of (seed, stream, ids[i], k),
    computed on ``ids``' device."""
    key = _mix32_int(_mix32_int(seed) ^ ((stream * _GOLD) & _M32))
    rows = _mix32((ids * _GOLD + key) & _M32)
    cols = torch.arange(width, dtype=torch.int64, device=ids.device) * _GOLD
    return _mix32((rows[:, None] + cols[None, :]) & _M32)


def hash_uniform(seed: int, stream: int, ids: torch.Tensor,
                 width: int) -> torch.Tensor:
    """(B, width) float32 U(0, 1) draws from ``hash_bits``: the top 24 bits
    plus one half, over 2^24, exact in float32 and never 0 or 1."""
    bits = hash_bits(seed, stream, ids, width) >> 8
    return (bits.to(F32) + 0.5) * (1.0 / (1 << 24))


def _swap_into(idx, pos, cand):
    """Propose ``idx[row, pos[row]] = cand[row]`` per row, masked where
    ``cand`` already sits in the row (a swap must introduce a NEW device).
    Returns (proposal, moved_mask)."""
    collision = (idx == cand[:, None]).any(dim=-1)
    nxt = idx.scatter(1, pos[:, None], cand[:, None])
    moved = ~collision
    return torch.where(moved[:, None], nxt, idx), moved


def _pick(x, i):
    """``x[i]`` for a 0-dim device index, without reading it back."""
    return x.index_select(0, i.view(1))[0]


# ---- host helpers (numpy; the reference's, call for call) -----------------

def _greedy_indices(times: np.ndarray, avail_idx: np.ndarray,
                    n_sel: int) -> np.ndarray:
    """Host helper: ids of the n_sel fastest available devices."""
    t_av = times[avail_idx]
    cut = np.argpartition(t_av, n_sel - 1)[:n_sel]
    return avail_idx[cut].astype(np.int32)


def _init_indices(rng: np.random.Generator, avail_idx: np.ndarray,
                  n_sel: int, rows: int) -> np.ndarray:
    """``rows`` random n_sel-subsets of the available set: strided windows
    of ONE permutation at random offsets (O(A + rows * n_sel)). Uniform
    marginals, distinct-within-row; rows are windows of the same
    permutation, which for a population INIT is diversity-preserving."""
    A = avail_idx.size
    perm = rng.permutation(A)
    offs = rng.integers(0, A, rows)
    pos = (offs[:, None] + np.arange(n_sel)[None, :]) % A
    return avail_idx[perm[pos]].astype(np.int32)


def _swap_noise(rng: np.random.Generator, avail_idx: np.ndarray,
                steps: int, rows: int, n_sel: int):
    """Pre-drawn swap/accept noise for ``steps`` iterations: the slot to
    vacate, the available device to propose (collisions with the current
    selection mask the move on the device), and the Metropolis uniform."""
    pos = rng.integers(0, n_sel, (steps, rows)).astype(np.int32)
    cand = avail_idx[rng.integers(0, avail_idx.size, (steps, rows))]
    u = rng.random((steps, rows)).astype(np.float32)
    return pos, cand.astype(np.int32), u


def _center(counts: np.ndarray) -> np.ndarray:
    counts = np.asarray(counts, dtype=np.float64)
    return (counts - float(counts.mean())).astype(np.float32)


def _check_avail(avail_idx: np.ndarray, n_sel: int) -> None:
    if avail_idx.size < n_sel:
        raise ValueError(
            f"need {n_sel} available devices, have {avail_idx.size}")


def _mutate_plan_host(rng: np.random.Generator, base: np.ndarray,
                      n_mut: int) -> np.ndarray:
    """Host twin of the BODS local-search proposal: n_mut copies of
    ``base``, each with 1-3 selected-for-unselected swaps (identical to the
    host scheduler's mutation loop; availability is restored on the device
    by the vectorized repair)."""
    K = base.shape[0]
    mutants = np.broadcast_to(base, (n_mut, K)).copy()
    for i in range(n_mut):
        flips = rng.integers(1, 4)
        on, off = np.flatnonzero(mutants[i]), np.flatnonzero(~mutants[i])
        for _ in range(flips):
            if on.size and off.size:
                mutants[i][rng.choice(on)] = False
                mutants[i][rng.choice(off)] = True
    return mutants


def _avail_ids(available, avail_idx, n_sel):
    avail = np.asarray(available, dtype=bool)
    if avail_idx is None:
        avail_idx = np.flatnonzero(avail)
    _check_avail(avail_idx, n_sel)
    return avail, avail_idx


# ---- (a) batched multi-chain simulated annealing --------------------------

def _temperatures(t0: float, cooling: float, steps: int) -> np.ndarray:
    """The f32 temperature of each step (carried and cooled in f32, as the
    reference's scan carries it), floored at 1e-9 for the exponent."""
    temps = np.empty(steps, np.float32)
    temp, cool = np.float32(t0), np.float32(cooling)
    for s in range(steps):
        temps[s] = temp
        temp = np.float32(temp * cool)
    return np.maximum(temps, np.float32(1e-9))


def _sa_run(init, times, counts_c, pos, cand, accept_u, temps, alpha, beta,
            ts, fs, delta_fairness: bool):
    """Anneal a block of (C, n_sel) chains for ``steps`` iterations on the
    device; returns each chain's best plan and cost (tensors). Chains never
    interact, so the cross-chain argmin runs outside, over every block."""
    cost = _idx_cost_fn(times, counts_c, alpha, beta, ts, fs,
                        delta_fairness)
    idx = init
    costs = cost(idx)
    best_i, best_c = idx, costs
    for s in range(pos.shape[0]):
        nxt, moved = _swap_into(idx, pos[s], cand[s])
        nxt_cost = cost(nxt)
        dc = nxt_cost - costs
        # Clamped Metropolis exponent: pathological cost spikes (huge
        # |dc| / tiny temp) stay finite instead of overflowing exp.
        acc_p = torch.exp(torch.clamp(-dc / temps[s], -60.0, 0.0))
        accept = moved & ((dc < 0.0) | (accept_u[s] < acc_p))
        idx = torch.where(accept[:, None], nxt, idx)
        costs = torch.where(accept, nxt_cost, costs)
        better = costs < best_c
        best_i = torch.where(better[:, None], idx, best_i)
        best_c = torch.where(better, costs, best_c)
        # Cooling advances even on masked (collision / no-free-device)
        # steps, so the schedule stays consistent across chains.
    return best_i, best_c


def sa_search(rng: np.random.Generator, times: np.ndarray, counts: np.ndarray,
              available: np.ndarray, n_sel: int, *, alpha: float, beta: float,
              time_scale: float, fairness_scale: float, delta_fairness: bool,
              steps: int, chains: int, t0: float, cooling: float,
              greedy_seed: bool = True,
              avail_idx: Optional[np.ndarray] = None,
              device: DeviceLike = "cuda", num_shards: int = 1,
              devices: Optional[Sequence] = None) -> np.ndarray:
    """One fused multi-chain SA decision -> (K,) bool plan.

    ``chains`` plans anneal in parallel for ``steps`` iterations; the best
    plan any chain ever visited is returned. All randomness is pre-drawn
    from ``rng`` on the host in the reference's order, so decisions follow
    the scheduler's seed. With ``num_shards`` > 1 the chain axis splits
    over the devices; the result is the single lane's bit for bit."""
    avail, avail_idx = _avail_ids(available, avail_idx, n_sel)
    init = _init_indices(rng, avail_idx, n_sel, chains)
    if greedy_seed:
        init[0] = _greedy_indices(np.asarray(times), avail_idx, n_sel)
    pos, cand, u = _swap_noise(rng, avail_idx, steps, chains, n_sel)
    n = _usable_search_shards(num_shards, chains, device=device,
                              devices=devices)
    devs = _search_devices(n, device, devices)
    Cb = chains // n
    temps = _temperatures(t0, cooling, int(steps))
    with span("sa_search", chains=int(chains), steps=int(steps)):
        bests = []
        for b, dev in enumerate(devs):
            rows = slice(b * Cb, (b + 1) * Cb)
            init_t, pos_t, cand_t = _to_device(
                dev, torch.int64, init[rows], pos[:, rows], cand[:, rows])
            times_t, counts_t, u_t, temps_t, coef = _to_device(
                dev, F32, times, _center(counts), u[:, rows], temps,
                [alpha, beta, time_scale, fairness_scale])
            bests.append(_sa_run(init_t, times_t, counts_t, pos_t, cand_t,
                                 u_t, temps_t, *coef.unbind(),
                                 bool(delta_fairness)))
        best_i = torch.cat([bi.to(devs[0]) for bi, _ in bests])
        best_c = torch.cat([bc.to(devs[0]) for _, bc in bests])
        best_idx = _pick(best_i, torch.argmin(best_c))
        plan = plan_from_indices(avail.shape[0], best_idx.cpu().numpy())
    return plan


# ---- (b) fused genetic algorithm ------------------------------------------

def _ga_children_block(pop, cost, ta, tb, cu, mu, mpos, mcand, off: int,
                       rows: int, n_sel: int, mutation_rate):
    """Rows ``[off, off + rows)`` of the next GA generation (before
    elitism), from the FULL (P, S) population and its (P,) costs but only
    this block's slices of the crossover and mutation noise (``cu`` per
    pair, the rest per row). The single lane calls it with ``off=0, rows=P``;
    a shard with its even block, so no parent pair straddles two blocks.

    Tournament selection (size 2) on the full arrays, then slot-wise
    uniform crossover between consecutive parent pairs: slot j of a child
    takes the OTHER parent's j-th device iff the coin says swap and that
    device is absent from this parent, so children stay duplicate-free and
    exactly n_sel-sized with no repair step. The two children use
    complementary coins. An odd last parent passes through. Mutation swaps
    one selected device for a free one where the draw is below
    ``mutation_rate``."""
    parents = torch.where((cost[ta] <= cost[tb])[:, None], pop[ta], pop[tb])
    par_l = parents[off:off + rows]
    pairs = rows // 2
    p0, p1 = par_l[0:2 * pairs:2], par_l[1:2 * pairs:2]
    m0 = (p0[:, :, None] == p1[:, None, :]).any(dim=-1)
    m1 = (p1[:, :, None] == p0[:, None, :]).any(dim=-1)
    swap = cu < 0.5
    c0 = torch.where(swap & ~m1, p1, p0)
    c1 = torch.where(~swap & ~m0, p0, p1)
    children = torch.stack([c0, c1], dim=1).reshape(2 * pairs, n_sel)
    if rows != 2 * pairs:
        children = torch.cat([children, par_l[-1:]])
    swapped, moved = _swap_into(children, mpos, mcand)
    apply = (mu < mutation_rate) & moved
    return torch.where(apply[:, None], swapped, children)


class _GABlock(NamedTuple):
    """One block of the GA population on its device: its rows of the
    initial population, the decision's replicated inputs and tournaments,
    its slices of the crossover (per pair) and mutation (per row) noise."""
    init: torch.Tensor
    times: torch.Tensor
    counts_c: torch.Tensor
    tourn_a: torch.Tensor
    tourn_b: torch.Tensor
    cross_u: torch.Tensor
    mut_u: torch.Tensor
    mut_pos: torch.Tensor
    mut_cand: torch.Tensor
    coef: torch.Tensor      # alpha, beta, ts, fs, mutation_rate


def _ga_run(blocks, delta_fairness: bool):
    """All generations over the population's blocks (``_GABlock``s, one a
    device). Each generation every block gathers the population and its
    costs (a no-op for the single lane), so selection and elitism see the
    global state. Returns the best plan seen and its cost (tensors on the
    first block's device)."""
    devs = [b.init.device for b in blocks]
    cost_of = [_idx_cost_fn(b.times, b.counts_c, *b.coef.unbind()[:4],
                            delta_fairness) for b in blocks]
    pop_l = [b.init for b in blocks]
    Pb, S = pop_l[0].shape
    state = [(b.init[0], torch.full((), torch.inf, dtype=F32, device=d))
             for b, d in zip(blocks, devs)]

    def gather(parts, dev):
        if len(parts) == 1:
            return parts[0]
        return torch.cat([x.to(dev) for x in parts])

    def improve(pop, cost, best_i, best_c):
        i = torch.argmin(cost)
        ci = _pick(cost, i)
        better = ci < best_c
        return (torch.where(better, _pick(pop, i), best_i),
                torch.where(better, ci, best_c))

    for g in range(blocks[0].tourn_a.shape[0]):
        cost_l = [c(p) for c, p in zip(cost_of, pop_l)]
        nxt = []
        for sid, (b, dev) in enumerate(zip(blocks, devs)):
            pop, cost = gather(pop_l, dev), gather(cost_l, dev)
            state[sid] = improve(pop, cost, *state[sid])
            children = _ga_children_block(
                pop, cost, b.tourn_a[g], b.tourn_b[g], b.cross_u[g],
                b.mut_u[g], b.mut_pos[g], b.mut_cand[g], sid * Pb, Pb, S,
                b.coef[4])
            if sid == 0:
                # Elitism: the best plan seen so far survives in global
                # slot 0, the first block's slot 0.
                children[0] = state[0][0]
            nxt.append(children)
        pop_l = nxt
    cost_l = [c(p) for c, p in zip(cost_of, pop_l)]
    return improve(gather(pop_l, devs[0]), gather(cost_l, devs[0]),
                   *state[0])


def ga_search(rng: np.random.Generator, times: np.ndarray, counts: np.ndarray,
              available: np.ndarray, n_sel: int, *, alpha: float, beta: float,
              time_scale: float, fairness_scale: float, delta_fairness: bool,
              population: int, generations: int, mutation_rate: float,
              greedy_seed: bool = True,
              avail_idx: Optional[np.ndarray] = None,
              device: DeviceLike = "cuda", num_shards: int = 1,
              devices: Optional[Sequence] = None) -> np.ndarray:
    """One fused GA decision -> (K,) bool plan (index-form population,
    noise pre-drawn from ``rng`` on the host in the reference's order).
    With ``num_shards`` > 1 the population breeds data-parallel over the
    devices, on the single lane's trajectory."""
    avail, avail_idx = _avail_ids(available, avail_idx, n_sel)
    P, G = population, generations
    init = _init_indices(rng, avail_idx, n_sel, P)
    if greedy_seed:
        init[0] = _greedy_indices(np.asarray(times), avail_idx, n_sel)
    tourn = rng.integers(0, P, (2, G, P)).astype(np.int32)
    half = P // 2
    cross_u = rng.random((G, half, n_sel)).astype(np.float32)
    mut_u = rng.random((G, P)).astype(np.float32)
    mut_pos, mut_cand, _ = _swap_noise(rng, avail_idx, G, P, n_sel)
    n = _usable_search_shards(num_shards, P, pairs=True, device=device,
                              devices=devices)
    devs = _search_devices(n, device, devices)
    Pb = P // n
    with span("ga_search", population=int(P), generations=int(G)):
        blocks = []
        for b, dev in enumerate(devs):
            rows = slice(b * Pb, (b + 1) * Pb)
            pair_rows = slice(b * Pb // 2, (b + 1) * Pb // 2)
            init_t, ta, tb, mpos, mcand = _to_device(
                dev, torch.int64, init[rows], tourn[0], tourn[1],
                mut_pos[:, rows], mut_cand[:, rows])
            times_t, counts_t, cu, mu, coef = _to_device(
                dev, F32, times, _center(counts), cross_u[:, pair_rows],
                mut_u[:, rows],
                [alpha, beta, time_scale, fairness_scale, mutation_rate])
            blocks.append(_GABlock(init_t, times_t, counts_t, ta, tb, cu, mu,
                                   mpos, mcand, coef))
        best_idx, _ = _ga_run(blocks, bool(delta_fairness))
        plan = plan_from_indices(avail.shape[0], best_idx.cpu().numpy())
    return plan


# ---- (c) the GP and Expected Improvement ----------------------------------

_SQRT5 = math.sqrt(5.0)


def _matern52(sq):
    r = torch.sqrt(torch.clamp(sq, min=1e-12))
    return (1.0 + _SQRT5 * r + 5.0 * sq / 3.0) * torch.exp(-_SQRT5 * r)


def _sq_dists(a, b):
    """(..., n, d) x (..., m, d) -> (..., n, m) squared distances."""
    return ((a[..., :, None, :] - b[..., None, :, :]) ** 2).sum(dim=-1)


def gp_fit(F, resid, valid, noise: float):
    """Masked Matern-5/2 GP fit over the observation ring (any leading
    batch axes): the Cholesky factor, the dual weights ``K_nn^-1 (resid *
    m)`` and the float mask ``m``. Unfilled slots get identity Gram rows,
    so the factor of a partly filled ring exists."""
    L = F.shape[-2]
    m = valid.to(F32)
    mm = m[..., :, None] * m[..., None, :]
    eye = torch.eye(L, dtype=F32, device=F.device)
    K_nn = _matern52(_sq_dists(F, F)) * mm + (1.0 - mm) * eye
    jitter = float(np.float32(noise) + np.float32(1e-6))
    K_nn = K_nn + jitter * eye
    chol, _ = torch.linalg.cholesky_ex(K_nn)
    # cho_solve as the reference's two triangular solves.
    b = (resid * m)[..., None]
    z = torch.linalg.solve_triangular(chol, b, upper=False)
    w = torch.linalg.solve_triangular(chol.mT, z, upper=True)[..., 0]
    return chol, w, m


def gp_posterior(chol, w, m, F, cand_feats, cand_est):
    """Posterior (mean, stddev) of a candidate block under a ``gp_fit``
    model; the prior mean enters through ``cand_est``."""
    K_nc = _matern52(_sq_dists(F, cand_feats)) * m[..., :, None]
    mu_c = cand_est + (K_nc.mT @ w[..., None])[..., 0]
    v = torch.linalg.solve_triangular(chol, K_nc, upper=False)
    var = torch.clamp(1.0 - (v * v).sum(dim=-2), min=1e-9)
    return mu_c, torch.sqrt(var)


_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)


def ei_from_posterior(mu_c, sigma, best):
    """Expected Improvement of each candidate against incumbent ``best``."""
    z = (best - mu_c) / sigma
    cdf = torch.special.ndtr(z)
    pdf = torch.exp(-0.5 * z * z) * _INV_SQRT_2PI
    return (best - mu_c) * cdf + sigma * pdf


def ei_scores(F, resid, valid, cand_feats, cand_est, noise: float):
    """Expected Improvement under the masked Matern-5/2 GP posterior.

    F: (L, d) observed features; resid: (L,) realized-estimated residuals
    (normalized); valid: (L,) ring mask; cand_feats: (P, d); cand_est: (P,)
    estimated candidate costs (same normalization as ``resid``). The
    incumbent is the within-round plugin best (the least posterior mean).
    Returns (P,) EI (higher = better). Leading batch axes pass through:
    with a leading (M,) axis on every argument but ``noise`` it scores all
    M jobs in one call, in batched ``torch.linalg`` calls, and returns
    (M, P); so it also stands for the reference's ``ei_scores_jobs``."""
    chol, w, m = gp_fit(F, resid, valid, noise)
    mu_c, sigma = gp_posterior(chol, w, m, F, cand_feats, cand_est)
    return ei_from_posterior(mu_c, sigma, mu_c.amin(dim=-1, keepdim=True))


# ---- (d) the BODS acquisition ---------------------------------------------

def _norm01_traced(x, mask):
    """Device twin of ``bods._norm01``: [0, 1]-normalize by the spread over
    ``mask``; a flat (or empty) reference set yields all-zeros, never NaN."""
    lo = torch.where(mask, x, torch.inf).amin()
    hi = torch.where(mask, x, -torch.inf).amax()
    spread = hi - lo
    ok = torch.isfinite(spread) & (spread >= 1e-9)
    safe = torch.where(ok, spread, 1.0)
    return torch.where(ok, torch.clamp((x - lo) / safe, 0.0, 1.0), 0.0)


def featurize_plans(times, counts_c, counts_zero, mu, plans, ts, fs,
                    n_sel: int, delta_fairness: bool):
    """phi(V): (P, K) bool plans -> (P, 6) features, formula for formula
    the host ``BODSScheduler._featurize`` (est round time, fairness
    increment, mean selected time, capability-jitter exposure, novelty,
    occupancy). Also returns the normalized time and fairness terms for the
    Formula-2 estimates. The round time, count and weight sum come from the
    plan-scoring kernel (``_dense_stats``)."""
    dev = plans.device
    K = plans.shape[1]
    ts, fs = _as_f32(ts, dev), _as_f32(fs, dev)
    t, n, wsum = _dense_stats(times, counts_c, plans)
    est_time = t / ts
    dfair = _fairness_from_stats(counts_c, n, wsum, delta_fairness) / fs
    nn = torch.clamp(n, min=1.0)
    sel_t = torch.where(plans, times[None, :], 0.0)
    mean_t = sel_t.sum(dim=1) / nn / ts
    jitter = torch.where(plans, (times / torch.clamp(mu, min=1e-9))[None, :],
                         0.0).amax(dim=1) / ts
    novelty = (plans & counts_zero[None, :]).sum(dim=1).to(F32) / \
        _as_f32(max(n_sel, 1), dev)
    occupancy = n / _as_f32(K, dev)
    feats = torch.stack([est_time, dfair, mean_t, jitter, novelty, occupancy],
                        dim=1).to(F32)
    return feats, est_time, dfair


def bods_candidates(seed: int, lo: int, rows: int, times, counts_c, avail,
                    mutants, num_candidates: int, n_sel: int,
                    use_base: bool):
    """The (rows, K) bool candidates with ids ``[lo, lo + rows)`` of a set
    of ``num_candidates``, on ``times``' device. Every draw is a pure
    function of (``seed``, candidate id, element) (``hash_uniform``), so a
    row is the same whichever block holds it. Layout as the reference's:
    ids [0, P/4) uniform Gumbel top-k, the rest structured (availability
    logits -w_time * t_norm - w_fair * c_norm, w_time in U(0, 6), w_fair in
    U(0, 4)); with ``use_base``, ids [0, n_mut) are the repaired (n_mut, K)
    ``mutants`` instead."""
    K = times.shape[0]
    n_rand = num_candidates // 4
    ids = torch.arange(lo, lo + rows, device=times.device)
    t_norm = _norm01_traced(times, avail)
    c_norm = _norm01_traced(counts_c, torch.ones_like(avail))
    w = hash_uniform(seed, _WEIGHTS, ids, 2)
    w_time, w_fair = w[:, :1] * 6.0, w[:, 1:] * 4.0
    logits = torch.where((ids >= n_rand)[:, None],
                         -w_time * t_norm[None, :] - w_fair * c_norm[None, :],
                         0.0)
    g = -torch.log(-torch.log(hash_uniform(seed, _GUMBEL, ids, K)))
    keys = torch.where(avail[None, :], logits + g, -torch.inf)
    cands = _topk_plans(keys, n_sel, avail)
    m = min(lo + rows, mutants.shape[0]) - lo if use_base else 0
    if m > 0:
        cands[:m] = _repair_with(hash_uniform(seed, _REPAIR, ids[:m], K),
                                 mutants[lo:lo + m], avail, n_sel)
    return cands


def bods_posterior(cands, times, counts_c, counts_zero, mu, F, resid, valid,
                   inv_sd, alpha, beta, ts, fs, noise: float, n_sel: int,
                   delta_fairness: bool):
    """A candidate block's featurization (kernel 2.1 on the block's
    device) and GP posterior: ((P,) posterior mean, (P,) stddev, (P,)
    estimated costs)."""
    feats, est_time, dfair = featurize_plans(
        times, counts_c, counts_zero, mu, cands, ts, fs, n_sel,
        delta_fairness)
    dev = cands.device
    cand_est = _as_f32(alpha, dev) * est_time + _as_f32(beta, dev) * dfair
    chol, w, m = gp_fit(F, resid, valid, noise)
    mu_c, sigma = gp_posterior(chol, w, m, F, feats,
                               cand_est * _as_f32(inv_sd, dev))
    return mu_c, sigma, cand_est


def bods_scores(cands, times, counts_c, counts_zero, mu, F, resid, valid,
                inv_sd, alpha, beta, ts, fs, noise: float, n_sel: int,
                delta_fairness: bool):
    """A candidate block end to end: featurization, GP posterior, EI
    against the block's own plugin incumbent. Returns ((P,) EI, (P,)
    estimated costs)."""
    mu_c, sigma, cand_est = bods_posterior(
        cands, times, counts_c, counts_zero, mu, F, resid, valid, inv_sd,
        alpha, beta, ts, fs, noise, n_sel, delta_fairness)
    return ei_from_posterior(mu_c, sigma, mu_c.amin()), cand_est


def bods_acquire(rng: np.random.Generator, times: np.ndarray,
                 counts: np.ndarray, available: np.ndarray, mu: np.ndarray,
                 n_sel: int, *, F: np.ndarray, y: np.ndarray,
                 est: np.ndarray, valid: np.ndarray,
                 base_plan: Optional[np.ndarray], alpha: float, beta: float,
                 time_scale: float, fairness_scale: float,
                 delta_fairness: bool, num_candidates: int, n_mut: int,
                 local_search: bool, gp_noise: float,
                 avail_idx: Optional[np.ndarray] = None,
                 device: DeviceLike = "cuda", num_shards: int = 1,
                 devices: Optional[Sequence] = None
                 ) -> Tuple[np.ndarray, float]:
    """One fused BODS decision: (chosen (K,) bool plan, its estimated cost).

    Candidate generation, featurization (kernel 2.1 on the device-resident
    block), GP posterior, EI and the argmax run on ``device``; only the
    ring slicing, the residual normalization and the local-search mutant
    loop stay on the host. The inputs go over in two copies and the plan
    with its estimate comes back in one (the decision's one wait on the
    device). With ``num_shards`` > 1 the candidate axis splits over the
    devices: each block generates, featurizes and scores its own
    candidates, the incumbent is the least posterior mean of all blocks,
    and the best EI wins, ties to the lowest candidate id: the single
    lane's candidates and decision."""
    avail, avail_idx = _avail_ids(available, avail_idx, n_sel)
    sd = float(y[valid > 0].std()) + 1e-6 if valid.sum() else 1.0
    use_base = base_plan is not None and local_search
    if use_base:
        mutants = _mutate_plan_host(rng, np.asarray(base_plan, dtype=bool),
                                    n_mut)
    else:
        mutants = np.zeros((0, avail.shape[0]), dtype=bool)
    seed = int(rng.integers(0, 2**31 - 1))
    P = int(num_candidates)
    n = _usable_search_shards(num_shards, P, device=device, devices=devices)
    devs = _search_devices(n, device, devices)
    Pb = P // n
    K = avail.shape[0]
    with span("bods_acquire", candidates=P, mutants=int(n_mut)):
        blocks = []
        for b, dev in enumerate(devs):
            times_t, counts_t, mu_t, F_t, resid_t, valid_t, coef = _to_device(
                dev, F32, times, _center(counts), mu, F,
                (y - est) / sd * valid, valid,
                [1.0 / sd, alpha, beta, time_scale, fairness_scale])
            zero_t, avail_t, mutants_t = _to_device(
                dev, torch.bool, np.asarray(counts) == 0, avail, mutants)
            cands = bods_candidates(seed, b * Pb, Pb, times_t, counts_t,
                                    avail_t, mutants_t, P, int(n_sel),
                                    use_base)
            mu_c, sigma, cand_est = bods_posterior(
                cands, times_t, counts_t, zero_t, mu_t, F_t, resid_t,
                valid_t, *coef.unbind(), gp_noise, int(n_sel),
                bool(delta_fairness))
            blocks.append((cands, mu_c, sigma, cand_est))
        home = devs[0]
        best = torch.stack([mu_c.amin().to(home)
                            for _, mu_c, _, _ in blocks]).amin()
        wins = []
        for cands, mu_c, sigma, cand_est in blocks:
            ei = ei_from_posterior(mu_c, sigma, best.to(mu_c.device))
            c = torch.argmax(ei)
            wins.append(torch.cat([_pick(ei, c).view(1),
                                   _pick(cand_est, c).view(1),
                                   _pick(cands, c).to(F32)]).to(home))
        # Max EI wins, ties to the lowest global candidate id (the single
        # lane's first argmax): the blocks hold ascending ids, and argmax
        # takes the first of equal values.
        wins = torch.stack(wins)
        out = _pick(wins, torch.argmax(wins[:, 0]))[1:].cpu().numpy()
    return out[1:K + 1] > 0.5, float(out[0])
