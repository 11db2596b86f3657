"""Fleet-axis sharding: million-device plan scoring in blocks of the fleet.

The scoring core (``repro_torch.core.scoring``) and the fused searches
(``repro_torch.core.search``) run one lane on one device. This module
splits the FLEET (K) axis into ``num_shards`` blocks of
``shard_sizes(K, N) = (ceil(K / N), N * ceil(K / N))``, the last padded
with devices that no plan selects:

- **Scoring** (``plan_stats_sharded``): each block reduces its (P, Kb)
  slice of the plans to the per-plan sufficient statistics of Formula 2
  (masked-max round time, selected count, sum of fairness weights). Under
  the ``cuda`` backend that is the plan-scoring kernel (2.1,
  ``ops.sched_plan_stats``) once per block; under ``torch`` its plain
  version. The N float32 partials are combined on the host in float64 (max
  of maxes, sum of counts, sum of weight sums) and finished by
  ``scoring._score_from_stats``. The index form ((P, n_sel) global ids)
  has no kernel: each block masks the ids outside ``[lo, lo + Kb)`` and
  gathers through the clipped offset.
- **Plan repair / candidate generation** (``repair_plans_sharded``,
  ``random_plan_indices_sharded``, ``gumbel_topk_indices_sharded``): each
  block draws its own noise from a ``torch.Generator`` on its device,
  seeded by a fixed function of (decision seed, shard id), takes a local
  top-k, and the merge keeps the top ``n_sel`` of the winners so far and
  each block's as the blocks arrive (a row's global top-k lies in the
  union of its blocks' top-k's).
  The draws depend on N: every N gives valid draws from the same
  distribution, not the same bits.

Two executors run the same per-block code:

- ``shard_map``: one block per CUDA device, in one process (the devices of
  ``fleet_devices(N)``, or the ``devices=`` list a caller passes: a test
  passes ``[cpu] * N``, ``chip_smoke.py`` the one card N times);
- ``emulate``: the N blocks in turn on ``device``, one block resident at a
  time, so a K = 1e6 draw at N = 8 holds one eighth of the keys.

``executor="auto"`` picks ``shard_map`` only on a card with
``torch.cuda.device_count() >= N`` (or when ``devices=`` names the
devices), and ``emulate`` otherwise.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.scoring import (DeviceLike, _plans_int8, h2d,
                                      resolve_device)

VALID_EXECUTORS = ("auto", "shard_map", "emulate")

#: Keys drawn at once by the top-k ops, per block (4 GB of float32): a
#: block's (rows, Kb) key matrix is drawn in row chunks of at most this.
MAX_DRAW_ELEMENTS = 1 << 30

# The kernel's value for a row that selects nothing in a block.
_EMPTY = -1e29


def shard_capacity() -> int:
    """Shard counts up to this run under ``shard_map`` on the cards."""
    return int(torch.cuda.device_count())


def resolve_num_shards(num_shards, fleet_size: Optional[int] = None) -> int:
    """The ``num_shards`` knob as a concrete shard count.

    ``None``/``1`` -> 1 (single lane); ``0`` or ``"auto"`` -> the CUDA
    device count, 1 where there is none. ``fleet_size`` caps the count, so
    no count exceeds the fleet."""
    if num_shards is None:
        return 1
    if num_shards == "auto" or num_shards == 0:
        n = max(shard_capacity(), 1)
    else:
        n = int(num_shards)
    if n < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards!r}")
    if fleet_size is not None:
        n = min(n, max(int(fleet_size), 1))
    return n


def shard_sizes(K: int, num_shards: int) -> Tuple[int, int]:
    """(per-shard block size Kb, padded fleet size Kb * num_shards)."""
    Kb = -(-int(K) // int(num_shards))
    return Kb, Kb * int(num_shards)


def fleet_devices(num_shards: int) -> List[torch.device]:
    """The first ``num_shards`` CUDA devices, one per block."""
    n = shard_capacity()
    if num_shards > n:
        raise ValueError(
            f"num_shards={num_shards} exceeds torch.cuda.device_count()={n}; "
            "use the emulate executor")
    return [torch.device("cuda", i) for i in range(num_shards)]


def _resolve_executor(executor: str, num_shards: int,
                      device: DeviceLike = "cuda",
                      devices: Optional[Sequence] = None) -> str:
    if executor not in VALID_EXECUTORS:
        raise ValueError(f"executor {executor!r} not in {VALID_EXECUTORS}")
    if executor != "auto":
        return executor
    if devices is not None:
        return "shard_map"
    on_card = torch.device(device).type == "cuda"
    return ("shard_map" if on_card and num_shards <= shard_capacity()
            else "emulate")


def block_devices(num_shards: int, executor: str = "auto",
                  device: DeviceLike = "cuda",
                  devices: Optional[Sequence] = None) -> List[torch.device]:
    """The device each of the ``num_shards`` blocks runs on: ``devices``
    (or ``fleet_devices``) under ``shard_map``, ``device`` N times under
    ``emulate``."""
    N = int(num_shards)
    ex = _resolve_executor(executor, N, device, devices)
    if ex == "emulate":
        if devices is not None:
            raise ValueError("devices= names the shard_map executor's "
                             "devices; emulate runs on device=")
        return [resolve_device(device)] * N
    if devices is None:
        return fleet_devices(N)
    devs = [resolve_device(d) for d in devices]
    if len(devs) != N:
        raise ValueError(f"{len(devs)} devices for {N} shards")
    return devs


# ---- shard-local sufficient statistics (Formula 2) ----------------------


def _partial_stats_dense(times_b, w_b, plans_b, impl: str):
    """One block: (Kb,) times, (Kb,) weights, (P, Kb) int8 plans -> (P, 3)
    f32 [masked-max t (-1e30 where the row selects nothing here), n
    selected, wsum]: kernel 2.1 (``impl="cuda"``) or its plain version
    (``"ref"``)."""
    from repro_torch.kernels import ops

    return ops.sched_plan_stats(times_b, w_b, plans_b, impl=impl)


def _partial_stats_index(times_b, w_b, idx, lo: int):
    """Index-form twin: (P, n_sel) GLOBAL device ids against the block
    ``[lo, lo + Kb)``: ids outside it are masked, ids inside gather through
    the clipped offset."""
    Kb = times_b.shape[0]
    rel = idx - lo
    own = (rel >= 0) & (rel < Kb)
    relc = rel.clamp(0, Kb - 1)
    t = torch.where(own, times_b[relc], -torch.inf).amax(dim=1)
    n = own.sum(dim=1).to(torch.float32)
    wsum = torch.where(own, w_b[relc], 0.0).sum(
        dim=1, dtype=torch.float64).to(torch.float32)
    return torch.stack([t, n, wsum], dim=1)


def _dense_block(p8: np.ndarray, lo: int, Kb: int) -> np.ndarray:
    """Columns ``[lo, lo + Kb)`` of the (P, K) int8 plans as a contiguous
    host block, zero-padded past K (padded devices are never selected)."""
    P, K = p8.shape
    hi = min(lo + Kb, K)
    if hi - lo == Kb:
        return np.ascontiguousarray(p8[:, lo:hi])
    out = np.zeros((P, Kb), dtype=np.int8)
    if hi > lo:
        out[:, :hi - lo] = p8[:, lo:hi]
    return out


def _combine(parts) -> np.ndarray:
    """N (P, 3) float32 partials -> (P, 3) float64 [t_max, n, wsum]: max of
    maxes (an empty block counts as -inf), sum of counts, sum of weight
    sums."""
    a = np.stack([p.cpu().numpy() for p in parts]).astype(np.float64)
    t = np.where(a[:, :, 0] > _EMPTY, a[:, :, 0], -np.inf)
    return np.stack([t.max(axis=0), a[:, :, 1].sum(axis=0),
                     a[:, :, 2].sum(axis=0)], axis=1)


def plan_stats_sharded(times: np.ndarray, counts_c: np.ndarray, plans,
                       form: str, num_shards: int, executor: str = "auto",
                       backend: str = "torch", device: DeviceLike = "cuda",
                       devices: Optional[Sequence] = None) -> np.ndarray:
    """Sharded Formula-2 sufficient statistics: (P, 3) float64 [t_max
    (-inf for a plan that selects nothing), n, wsum].

    ``counts_c`` must be mean-centred (the scoring core's convention);
    ``plans`` is (P, K) membership when ``form == "dense"``, (P, n_sel)
    global device ids when ``form == "index"``. ``backend`` ``cuda`` runs
    kernel 2.1 on each dense block (a failed build or launch raises),
    ``torch`` its plain version; the index form gathers in torch under
    both. Feed the result to ``scoring._score_from_stats``."""
    if backend not in ("torch", "cuda"):
        raise ValueError(f"backend {backend!r} not in ('torch', 'cuda')")
    if form not in ("dense", "index"):
        raise ValueError(f"form {form!r} not in ('dense', 'index')")
    devs = block_devices(num_shards, executor, device, devices)
    times = np.asarray(times)
    K = times.shape[0]
    Kb, Kpad = shard_sizes(K, len(devs))
    t32 = np.zeros(Kpad, np.float32)
    t32[:K] = times
    w32 = np.zeros(Kpad, np.float32)
    w32[:K] = 2.0 * np.asarray(counts_c, np.float32) + 1.0
    if form == "dense":
        p8 = _plans_int8(np.atleast_2d(np.asarray(plans)))
        impl = "cuda" if backend == "cuda" else "ref"
    else:
        idx = np.atleast_2d(np.asarray(plans)).astype(np.int64)
    parts = []
    for s, dev in enumerate(devs):
        lo = s * Kb
        t_b = h2d(t32[lo:lo + Kb], dev)
        w_b = h2d(w32[lo:lo + Kb], dev)
        if form == "dense":
            parts.append(_partial_stats_dense(
                t_b, w_b, h2d(_dense_block(p8, lo, Kb), dev), impl))
        else:
            parts.append(_partial_stats_index(t_b, w_b, h2d(idx, dev), lo))
    return _combine(parts)


# ---- shard-local top-k with cross-shard merge ---------------------------
#
# The repair / candidate-generation primitives share one shape: a (P, K)
# priority-key matrix (valid selections outrank noise outranks occupied),
# each row's top n_sel. Sharded, each block draws ITS noise, takes a local
# top-k, and the merge keeps the top n_sel of the winners so far and the
# block's.

_MODES = ("repair", "random", "gumbel")


def _shard_seed(seed: int, sid: int) -> int:
    """The seed of shard ``sid``'s generator for a decision seed ``seed``
    (injective in both: the seed's 32 bits above the shard id's)."""
    return ((int(seed) & 0xFFFFFFFF) << 32) | (int(sid) & 0xFFFFFFFF)


def _local_keys(mode: str, gen, avail_b, mat_b, rows: int):
    """One row chunk of a block's priority keys: (rows, Kb) float32,
    -inf where the device is unavailable."""
    shape = (rows, avail_b.shape[0])
    keys = torch.rand(shape, generator=gen, device=avail_b.device,
                      dtype=torch.float32)
    if mode == "repair":
        keys += (mat_b & avail_b[None, :]).to(torch.float32)
    elif mode == "gumbel":
        keys.clamp_(min=torch.finfo(torch.float32).tiny)
        keys = mat_b - torch.log(-torch.log(keys))
    return keys.masked_fill_(~avail_b[None, :], -torch.inf)


def _local_topk(mode: str, gen, avail_b, mat_b, P: int, n_sel: int, lo: int):
    """A block's local winners: (P, n_sel) keys and GLOBAL ids, padded with
    -inf (id 0) where the block has fewer than n_sel devices. The keys are
    drawn in row chunks of at most ``MAX_DRAW_ELEMENTS``."""
    Kb = avail_b.shape[0]
    m = min(n_sel, Kb)
    step = max(1, MAX_DRAW_ELEMENTS // max(Kb, 1))
    vals, ids = [], []
    for r0 in range(0, P, step):
        r1 = min(P, r0 + step)
        mat = None if mat_b is None else mat_b[r0:r1]
        keys = _local_keys(mode, gen, avail_b, mat, r1 - r0)
        v, i = torch.topk(keys, m, dim=1, sorted=False)
        del keys
        vals.append(v)
        ids.append(i + lo)
    v, gi = torch.cat(vals), torch.cat(ids)
    if m < n_sel:
        pad = n_sel - m
        v = torch.cat([v, v.new_full((P, pad), -torch.inf)], dim=1)
        gi = torch.cat([gi, gi.new_zeros((P, pad))], dim=1)
    return v, gi


def _topk_call(mode: str, seed: int, avail: np.ndarray, n_sel: int,
               num_shards: int, executor: str, mat=None,
               rows: Optional[int] = None, device: DeviceLike = "cuda",
               devices: Optional[Sequence] = None) -> np.ndarray:
    if mode not in _MODES:
        raise ValueError(f"mode {mode!r} not in {_MODES}")
    devs = block_devices(num_shards, executor, device, devices)
    avail = np.asarray(avail, dtype=bool)
    K = avail.shape[0]
    if int(avail.sum()) < n_sel:
        raise ValueError(
            f"need {n_sel} available devices, have {int(avail.sum())}")
    Kb, Kpad = shard_sizes(K, len(devs))
    a = np.zeros(Kpad, dtype=bool)
    a[:K] = avail
    if mode == "random":
        P = int(rows)
    else:
        mat = np.atleast_2d(np.asarray(
            mat, dtype=bool if mode == "repair" else np.float32))
        P = mat.shape[0]
        if Kpad != K:
            mat = np.pad(mat, ((0, 0), (0, Kpad - K)))
    home = devs[0]
    top_v = top_i = None
    for s, dev in enumerate(devs):
        lo = s * Kb
        gen = torch.Generator(device=dev)
        gen.manual_seed(_shard_seed(seed, s))
        mat_b = None if mode == "random" else h2d(mat[:, lo:lo + Kb], dev)
        v, gi = _local_topk(mode, gen, h2d(a[lo:lo + Kb], dev), mat_b, P,
                            int(n_sel), lo)
        v, gi = v.to(home), gi.to(home)
        if top_v is not None:
            # The merge runs as the blocks arrive: the winners so far
            # against this block's, (P, 2 n_sel) at a time at any N.
            v, gi = torch.cat([top_v, v], dim=1), torch.cat([top_i, gi], dim=1)
            v, pick = torch.topk(v, int(n_sel), dim=1, sorted=False)
            gi = gi.gather(1, pick)
        top_v, top_i = v, gi
    return top_i.cpu().numpy().astype(np.int32)


def repair_plans_sharded(rng: np.random.Generator, plans: np.ndarray,
                         available: np.ndarray, n_sel: int, num_shards: int,
                         executor: str = "auto", device: DeviceLike = "cuda",
                         devices: Optional[Sequence] = None) -> np.ndarray:
    """Fleet-sharded twin of ``plans.repair_plans``: (P, K) candidates ->
    (P, n_sel) repaired GLOBAL indices by shard-local priority top-k and
    the cross-shard merge. Valid selections (selected and available) always
    outrank noise, so valid plans pass through unchanged (as a set);
    occupied devices are dropped, random available devices top up."""
    seed = int(rng.integers(0, 2**31 - 1))
    return _topk_call("repair", seed, available, int(n_sel), num_shards,
                      executor, mat=np.atleast_2d(plans), device=device,
                      devices=devices)


def random_plan_indices_sharded(rng: np.random.Generator,
                                available: np.ndarray, n_sel: int,
                                count: int, num_shards: int,
                                executor: str = "auto",
                                device: DeviceLike = "cuda",
                                devices: Optional[Sequence] = None
                                ) -> np.ndarray:
    """Fleet-sharded twin of ``plans.random_plan_indices``: uniform
    n_sel-subsets of the available set, (count, n_sel) global ids, the
    (count, K) keys drawn block by block on the device (never a (count, K)
    host matrix)."""
    if count == 0 or n_sel == 0:
        return np.zeros((count, n_sel), dtype=np.int32)
    seed = int(rng.integers(0, 2**31 - 1))
    return _topk_call("random", seed, available, int(n_sel), num_shards,
                      executor, rows=int(count), device=device,
                      devices=devices)


def gumbel_topk_indices_sharded(rng: np.random.Generator,
                                logits: np.ndarray, available: np.ndarray,
                                n_sel: int, num_shards: int,
                                executor: str = "auto",
                                device: DeviceLike = "cuda",
                                devices: Optional[Sequence] = None
                                ) -> np.ndarray:
    """Fleet-sharded twin of ``plans.gumbel_topk_plans`` returning INDEX
    form: per-row Plackett-Luce draws over the available set, each block
    drawing its own Gumbel noise."""
    seed = int(rng.integers(0, 2**31 - 1))
    return _topk_call("gumbel", seed, available, int(n_sel), num_shards,
                      executor, mat=np.atleast_2d(logits), device=device,
                      devices=devices)
