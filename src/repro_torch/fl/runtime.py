"""Job runtimes: what happens when a round's devices "train".

``FusedMultiRuntime`` — the default real-training path, behind the same
engine protocol as the reference's fused runtime. Per round and job: the
cohort's shards are gathered from device-resident ``(x, y, partition)``
tensors, local SGD runs across the cohort at once
(``torch.func.vmap(torch.func.grad(loss))``, one Python loop over epochs
and steps), FedAvg weights each device by its REAL partition size, and the
held-out set is evaluated (every ``eval_every``-th round; skipped rounds
report the last evaluated metrics). Jobs sharing a model config form one
group; the engine announces realised cohorts at launch (``begin_round``)
and the first result demand flushes every pending round of the group.

Two artifacts of the reference's jit need no counterpart here, since
PyTorch runs eagerly. Cohorts were padded to power-of-two ``buckets`` with
zero-weight lanes so that jit would not recompile per cohort size; padded
lanes add exact zeros to FedAvg and fall outside the robust median, so the
port trains only the real lanes. ``buckets`` is still accepted (a cohort
larger than the largest bucket still raises) and ``recompiles`` stays 0.
The reference's lane-free dispatch of one-job groups existed for XLA's
bitwise tiling; the port loops over a group's jobs.

``FLJobRuntime`` — the one-job unfused path (same math: host-side
partition gather, FedAvg and eval each round), behind ``MultiRuntime``.

``SyntheticRuntime`` — closed-form convergence model for scheduler-only
studies and fast tests: accuracy follows a saturating curve whose CEILING is
set by label coverage of the devices scheduled so far (non-IID: each device
holds 2 of C classes, so starving devices starves classes — the mechanism the
paper's fairness term addresses) and whose RATE follows Formula 13.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config.base import JobConfig, ModelConfig
from repro_torch.fl.aggregation import fedavg, robust_fedavg
from repro_torch.models.cnn_zoo import (cnn_apply, cnn_init,
                                        cnn_loss_and_accuracy, cross_entropy)
from repro_torch.monitoring.trace import span
from repro_torch.tree import tree_map


# ---- local SGD ----

def _split_batches(x, y, batch_size: int, axis: int):
    """(…, W, …) shards -> (…, steps, batch, …) along ``axis`` (0 for one
    device, 1 for a cohort). Devices holding fewer than ``batch_size``
    samples train on one full-shard batch; the ragged tail is dropped."""
    W = x.shape[axis]
    batch_size = min(batch_size, W)
    steps = max(W // batch_size, 1)
    lead = x.shape[:axis]
    xb = x.narrow(axis, 0, steps * batch_size).reshape(
        *lead, steps, batch_size, *x.shape[axis + 1:])
    yb = y.narrow(axis, 0, steps * batch_size).reshape(
        *lead, steps, batch_size)
    return xb, yb, steps


def _sgd(params, grad_fn, xb, yb, steps: int, epochs: int, lr: float,
         axis: int):
    p = params
    for _ in range(epochs):
        for s in range(steps):
            g = grad_fn(p, xb.select(axis, s), yb.select(axis, s))
            p = tree_map(lambda pp, gg: pp - lr * gg, p, g)
    return p


def _loss_fn(cfg: ModelConfig):
    return lambda p, bx, by: cross_entropy(cnn_apply(p, cfg, bx), by)


def _local_train_one(params, cfg: ModelConfig, x, y, epochs: int,
                     batch_size: int, lr: float):
    """SGD local update of one device. x: (W, ...), y: (W,)."""
    if x.shape[0] == 0:
        # Width-0 shard (an empty device): the local update is the identity.
        return params
    xb, yb, steps = _split_batches(x, y, batch_size, axis=0)
    return _sgd(params, torch.func.grad(_loss_fn(cfg)), xb, yb, steps,
                epochs, lr, axis=0)


def _local_train_batch(params, cfg: ModelConfig, x, y, epochs: int,
                       batch_size: int, lr: float):
    """``_local_train_one`` across a cohort: x (n, W, ...), y (n, W) ->
    params stacked on a leading (n,) device axis."""
    n = x.shape[0]
    stacked = tree_map(lambda leaf: leaf.expand(n, *leaf.shape), params)
    if x.shape[1] == 0:
        return tree_map(torch.clone, stacked)
    xb, yb, steps = _split_batches(x, y, batch_size, axis=1)
    grad_fn = torch.func.vmap(torch.func.grad(_loss_fn(cfg)))
    return _sgd(stacked, grad_fn, xb, yb, steps, epochs, lr, axis=1)


# ---- cohort-size buckets ----

def default_buckets(num_devices: int, lo: int = 4) -> Tuple[int, ...]:
    """Powers of two from ``lo`` up, capped by (and always including) the
    pool size, so any cohort 1..num_devices maps to a bucket."""
    out, b = [], lo
    while b < num_devices:
        out.append(b)
        b *= 2
    out.append(num_devices)
    return tuple(sorted(set(out)))


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n (buckets must be sorted and cover n)."""
    for b in buckets:
        if b >= n:
            return b
    raise ValueError(f"cohort of {n} exceeds the largest bucket {buckets[-1]}")


# ---- one job's round ----

def _inject_corruption(p, locals_, corrupt, corrupt_mode: str,
                       corrupt_scale: float):
    """Overwrite corrupted lanes' uploads: all-NaN params (``"nan"``) or a
    delta blown up by ``corrupt_scale`` (``"scale"``). ``corrupt``: (n,)
    bool."""

    def leaf(g, l):
        c = corrupt.reshape((-1,) + (1,) * (l.dim() - 1))
        if corrupt_mode == "nan":
            bad = torch.full_like(l, torch.nan)
        else:
            bad = g[None] + corrupt_scale * (l - g[None])
        return torch.where(c, bad, l)

    return tree_map(leaf, p, locals_)


def _train_round(params, ids, x, y, partition, sizes, corrupt,
                 cfg: ModelConfig, epochs: int, batch_size: int, lr: float,
                 robust: bool, reject_mult: float, corrupt_mode: str,
                 corrupt_scale: float):
    """Gather + local SGD + FedAvg (robust: corruption injected, then
    screened) for one job's cohort ``ids`` (n,) on the device. Returns
    (new_params, rejected count as a 0-dim tensor)."""
    idx = partition[ids]                                 # (n, W)
    locals_ = _local_train_batch(params, cfg, x[idx], y[idx], epochs,
                                 batch_size, lr)
    w = sizes[ids]                                       # real sizes
    if not robust:
        return fedavg(locals_, w), torch.zeros((), device=w.device)
    locals_ = _inject_corruption(params, locals_, corrupt, corrupt_mode,
                                 corrupt_scale)
    agg, ok = robust_fedavg(params, locals_, w, reject_mult)
    return agg, (~ok).sum().to(torch.float32)


@dataclasses.dataclass
class _FusedGroup:
    """Jobs sharing (model arch, local hyperparams, data shapes)."""

    cfg: ModelConfig                 # canonical (name-stripped) config
    epochs: int
    batch_size: int
    lr: float
    job_ids: List[int]
    lane: Dict[int, int]             # job_id -> lane index
    params: List[object]             # per lane: param pytree
    x: torch.Tensor                  # (J, N, ...)
    y: torch.Tensor                  # (J, N) int64
    partition: torch.Tensor          # (J, K, W) int64
    sizes: torch.Tensor              # (J, K) f32
    eval_x: torch.Tensor             # (J, E, ...)
    eval_y: torch.Tensor             # (J, E) int64


class FusedMultiRuntime:
    """Multi-job training runtime behind the engine protocol.

    ``begin_round`` (called by the engine at LAUNCH time with the realized
    survivor cohort) queues work; ``run_round`` (called at FINISH time)
    flushes every queued round, group by group, and returns that job's
    metrics. Works standalone too: ``run_round`` without a prior
    ``begin_round`` queues-and-flushes synchronously.

    ``datasets``: per-job ``(x, y, partition, eval_x, eval_y)`` tuples (or
    6-tuples with trailing per-device ``partition_sizes``), numpy arrays,
    moved to ``device`` once. ``eval_every``: evaluate every k-th round of
    a job; skipped rounds report the last evaluated metrics. A flush
    evaluates every flushed job of a group if ANY of them is due.

    ``robust`` turns on fault screening (``TrainSpec.robust``): the runtime
    takes over corrupted-upload handling from the engine
    (``handles_corruption``), re-draws each round's corrupt mask from
    ``fault_engine`` (the replayable keyed schedule), injects the garbage
    uploads itself, and rejects non-finite/outlier updates at a
    ``reject_mult`` x masked-median norm threshold. Per-round rejection
    counts ride on the metrics dict (``"rejected"``) and accumulate in
    ``rejected_total``. ``buckets``: see the module docstring.
    """

    def __init__(self, jobs: Sequence[JobConfig], datasets: Sequence[tuple],
                 seed: int = 0, buckets: Optional[Sequence[int]] = None,
                 eval_every: int = 1, robust: bool = False,
                 reject_mult: float = 4.0, fault_engine=None,
                 device="cuda"):
        if len(jobs) != len(datasets):
            raise ValueError("one dataset tuple per job required")
        if eval_every < 1:
            raise ValueError(f"eval_every must be >= 1, got {eval_every}")
        self.device = torch.device(device)
        self.eval_every = int(eval_every)
        self.robust = bool(robust)
        self.reject_mult = float(reject_mult)
        self.fault_engine = fault_engine
        self.rejected_total = 0.0
        self.recompiles = 0  # eager execution: nothing is ever recompiled
        self._queued: Dict[int, tuple] = {}      # job -> (ids, round_idx)
        self._results: Dict[tuple, tuple] = {}   # (job, round) -> metrics
        self._last: Dict[int, tuple] = {}        # job -> last evaluated
        self.groups: List[_FusedGroup] = []
        self._group_of: Dict[int, _FusedGroup] = {}

        by_key: Dict[tuple, list] = {}
        for jid, (job, ds) in enumerate(zip(jobs, datasets)):
            x, y, part, ex, ey = ds[:5]
            psz = ds[5] if len(ds) > 5 else None
            canon = dataclasses.replace(job.model, name="")
            key = (canon, job.local_epochs, job.batch_size, job.lr,
                   np.shape(x), np.shape(part), np.shape(ex))
            by_key.setdefault(key, []).append((jid, job, x, y, part, ex, ey,
                                               psz))

        dev = self.device
        stack = lambda arrays, dtype: torch.stack([
            torch.as_tensor(np.asarray(a), dtype=dtype) for a in arrays
        ]).to(dev)
        num_devices = None
        for key, members in by_key.items():
            canon, epochs, bs, lr = key[0], key[1], key[2], key[3]
            job_ids = [m[0] for m in members]
            K, W = np.shape(members[0][4])
            num_devices = K if num_devices is None else max(num_devices, K)
            grp = _FusedGroup(
                cfg=canon, epochs=epochs, batch_size=bs, lr=lr,
                job_ids=job_ids, lane={jid: i for i, jid in enumerate(job_ids)},
                params=[cnn_init(canon, seed=seed + m[0], device=dev)
                        for m in members],
                x=stack([m[2] for m in members], torch.float32),
                y=stack([m[3] for m in members], torch.int64),
                partition=stack([m[4] for m in members], torch.int64),
                sizes=stack([np.full(K, W) if m[7] is None else m[7]
                             for m in members], torch.float32),
                eval_x=stack([m[5] for m in members], torch.float32),
                eval_y=stack([m[6] for m in members], torch.int64))
            self.groups.append(grp)
            for jid in job_ids:
                self._group_of[jid] = grp
        self.buckets = (tuple(sorted(set(buckets))) if buckets is not None
                        else default_buckets(num_devices))
        if self.buckets[-1] < num_devices:
            self.buckets = self.buckets + (num_devices,)

    # ---- engine protocol ----

    @property
    def handles_corruption(self) -> bool:
        """Robust mode screens corrupted uploads inside aggregation, so the
        engine must NOT oracle-discard them from the cohort."""
        return self.robust

    def begin_round(self, job_id: int, device_ids: np.ndarray,
                    round_idx: int) -> None:
        """Announce a launched round's REALIZED cohort (post drop/failure).
        Pure bookkeeping — training runs at the next flush."""
        self._queued[job_id] = (np.asarray(device_ids, np.int64), round_idx)

    def run_round(self, job_id: int, device_ids: np.ndarray, round_idx: int
                  ) -> Dict[str, float]:
        key = (job_id, round_idx)
        ids = np.asarray(device_ids, np.int64)
        if key not in self._results:
            queued = self._queued.get(job_id)
            if (queued is None or queued[1] != round_idx
                    or not np.array_equal(queued[0], ids)):
                # No announcement, or the announced cohort drifted: the
                # demanded cohort wins (nothing has been computed yet).
                self.begin_round(job_id, ids, round_idx)
            self._flush()
        (loss, acc), trained_ids, rej = self._results.pop(key)
        if not np.array_equal(trained_ids, ids):
            raise ValueError(
                f"job {job_id} round {round_idx} was trained on the cohort "
                f"announced via begin_round, which differs from the one "
                f"passed to run_round: {trained_ids} vs {ids}")
        # The host waits for the card HERE, per demand: a flush queues every
        # pending job's work without synchronising.
        with span("metrics_sync", job=job_id, round=round_idx):
            out = {"loss": float(loss), "accuracy": float(acc)}
            if self.robust:
                out["rejected"] = float(rej)
                self.rejected_total += out["rejected"]
        return out

    # ---- execution ----

    def _flush(self) -> None:
        queued, self._queued = self._queued, {}
        fspec = getattr(self.fault_engine, "spec", None)
        corrupt_mode = fspec.corrupt_mode if fspec is not None else "nan"
        corrupt_scale = float(fspec.corrupt_scale) if fspec is not None else 1.0
        for grp in self.groups:
            pend = [(jid,) + queued[jid] for jid in grp.job_ids
                    if jid in queued]
            if not pend:
                continue
            B = bucket_for(max(len(ids) for _, ids, _ in pend), self.buckets)
            do_eval = any(r % self.eval_every == 0 or jid not in self._last
                          for jid, _, r in pend)
            with span("fused_round", jobs=len(pend), bucket=B,
                      eval=bool(do_eval)):
                for jid, ids, r in pend:
                    ln = grp.lane[jid]
                    corrupt = np.zeros(len(ids), bool)
                    if self.robust and self.fault_engine is not None:
                        # The SAME keyed draw the engine made for this round.
                        corrupt = self.fault_engine.corrupt_mask(jid, r, ids)
                    grp.params[ln], rej = _train_round(
                        grp.params[ln],
                        torch.as_tensor(ids, device=self.device),
                        grp.x[ln], grp.y[ln], grp.partition[ln],
                        grp.sizes[ln],
                        torch.as_tensor(corrupt, device=self.device),
                        grp.cfg, grp.epochs, grp.batch_size, grp.lr,
                        self.robust, self.reject_mult, corrupt_mode,
                        corrupt_scale)
                    if do_eval:
                        with torch.no_grad():
                            metrics = cnn_loss_and_accuracy(
                                grp.params[ln], grp.cfg, grp.eval_x[ln],
                                grp.eval_y[ln])
                        self._last[jid] = metrics
                    # The trained cohort rides along so a demand with a
                    # DIFFERENT cohort fails loudly instead of
                    # mis-attributing metrics.
                    self._results[(jid, r)] = (self._last[jid], ids, rej)

    # ---- introspection and hand-over (tests / carrying a run across) ----

    def params_of(self, job_id: int):
        """Param pytree of one job."""
        grp = self._group_of[job_id]
        return grp.params[grp.lane[job_id]]

    def load_params(self, job_id: int, params) -> None:
        """Replace one job's params (same structure and shapes; numpy
        arrays or tensors, e.g. the reference's as ``jax.device_get`` gives
        them)."""
        grp = self._group_of[job_id]
        ln = grp.lane[job_id]

        def leaf(old, new):
            if tuple(np.shape(new)) != tuple(old.shape):
                raise ValueError(f"param of shape {tuple(np.shape(new))} "
                                 f"where {tuple(old.shape)} is expected")
            if not isinstance(new, torch.Tensor):
                new = torch.from_numpy(np.array(new))
            return new.to(device=old.device, dtype=old.dtype, copy=True)

        grp.params[ln] = tree_map(leaf, grp.params[ln], params)


class FLJobRuntime:
    """Unfused runtime for ONE job: host-side partition gather, local SGD
    across the cohort, FedAvg and eval every round. FedAvg weights are the
    REAL per-device partition sizes (``partition_sizes``; defaults to the
    fixed partition width, under which all weights are equal)."""

    def __init__(self, job: JobConfig, x: np.ndarray, y: np.ndarray,
                 partition: np.ndarray, eval_x: np.ndarray, eval_y: np.ndarray,
                 seed: int = 0, partition_sizes: Optional[np.ndarray] = None,
                 device="cuda"):
        self.job = job
        self.cfg = job.model
        self.device = torch.device(device)
        self.x = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        self.y = torch.as_tensor(np.asarray(y, np.int64), device=self.device)
        self.partition = partition
        if partition_sizes is None:
            partition_sizes = np.full(partition.shape[0], partition.shape[1])
        self.partition_sizes = np.asarray(partition_sizes, np.float64)
        if self.partition_sizes.shape != (partition.shape[0],):
            raise ValueError(
                f"partition_sizes has shape {self.partition_sizes.shape}, "
                f"expected ({partition.shape[0]},)")
        self.eval_x = torch.as_tensor(np.asarray(eval_x, np.float32),
                                      device=self.device)
        self.eval_y = torch.as_tensor(np.asarray(eval_y, np.int64),
                                      device=self.device)
        self.params = cnn_init(self.cfg, seed=seed, device=self.device)

    def run_round(self, job_id: int, device_ids: np.ndarray, round_idx: int
                  ) -> Dict[str, float]:
        ids = np.asarray(device_ids)
        idx = torch.as_tensor(self.partition[ids], device=self.device)
        locals_ = _local_train_batch(
            self.params, self.cfg, self.x[idx], self.y[idx],
            self.job.local_epochs, self.job.batch_size, self.job.lr)
        weights = torch.as_tensor(self.partition_sizes[ids],
                                  dtype=torch.float32, device=self.device)
        self.params = fedavg(locals_, weights)
        with torch.no_grad():
            loss, acc = cnn_loss_and_accuracy(self.params, self.cfg,
                                              self.eval_x, self.eval_y)
        return {"loss": float(loss), "accuracy": float(acc)}


class MultiRuntime:
    """Adapter: one FLJobRuntime per job behind the engine's JobRuntime protocol."""

    def __init__(self, runtimes):
        self.runtimes = list(runtimes)

    def run_round(self, job_id: int, device_ids: np.ndarray, round_idx: int):
        return self.runtimes[job_id].run_round(job_id, device_ids, round_idx)


DEFAULT_B0 = 0.15  # Formula 13 convergence rate when a job doesn't set one


class SyntheticRuntime:
    """Closed-form convergence: ceiling from class coverage, rate from Formula 13.

    acc_m(r) = ceiling_m * (1 - 1/(b0_m * r_eff + 1))  with r_eff the round
    count and ceiling_m = base + (1 - base) * coverage^p. coverage = fraction
    of the job's label classes seen in scheduled devices so far. Under IID
    (classes_per_device == num_classes) the ceiling is ~1 regardless, matching
    the paper's observation that fairness matters most under non-IID.

    ``b0`` is a scalar shared by all jobs or a (num_jobs,) array of per-job
    rates, so job complexity ordering (LeNet > CNN > VGG) converges at
    genuinely different speeds; ``None`` entries fall back to ``DEFAULT_B0``.
    """

    def __init__(self, num_jobs: int, num_devices: int, num_classes: int = 10,
                 classes_per_device: int = 2, b0=DEFAULT_B0,
                 base: float = 0.35, power: float = 1.5, seed: int = 0,
                 noise: float = 0.004):
        rng = np.random.default_rng(seed)
        self.num_classes = num_classes
        if num_devices > 4096:
            # Fleet pools: batched sampling-without-replacement (random keys
            # + argpartition) — one vectorized draw instead of num_devices
            # sequential rng.choice calls (milliseconds at K=100k). Same
            # distribution as the sequential draw; realizations differ, so
            # paper-scale pools keep the historical per-device stream below.
            keys = rng.random((num_devices, num_classes))
            self.device_classes = np.argpartition(
                keys, classes_per_device - 1, axis=1)[:, :classes_per_device]
        else:
            self.device_classes = np.stack([
                rng.choice(num_classes, size=classes_per_device, replace=False)
                for _ in range(num_devices)])
        self.seen = [np.zeros(num_classes, dtype=np.float64) for _ in range(num_jobs)]
        self.rounds = np.zeros(num_jobs, dtype=np.int64)
        if np.ndim(b0) > 0:
            b0 = np.array([DEFAULT_B0 if v is None else float(v) for v in b0])
            if b0.shape != (num_jobs,):
                raise ValueError(f"b0 has shape {b0.shape}, expected ({num_jobs},)")
        self.b0, self.base, self.power = b0, base, power
        self.noise = noise
        self.rng = rng

    def add_job(self, job_id: int, config=None, b0: Optional[float] = None
                ) -> None:
        """Dynamic job admission (scheduler-service hook): grow the per-job
        coverage/round state by one row. ``job_id`` must be the next index
        (or an existing row, which is RESET — a readmitted tenant starts a
        fresh model; its scheduler history transfers separately). A per-job
        ``b0`` promotes a scalar rate to a per-job array on first use."""
        if job_id > len(self.seen):
            raise ValueError(f"add_job out of order: job_id {job_id} with "
                             f"{len(self.seen)} existing jobs")
        if b0 is None and config is not None:
            b0 = getattr(config, "b0", None)
        if job_id == len(self.seen):
            self.seen.append(np.zeros(self.num_classes, dtype=np.float64))
            self.rounds = np.concatenate([self.rounds, np.zeros(1, np.int64)])
            if b0 is not None:
                b = np.asarray(self.b0, dtype=np.float64)
                if b.ndim == 0:
                    b = np.full(len(self.seen) - 1, float(b))
                self.b0 = np.concatenate([b, [float(b0)]])
            elif np.ndim(self.b0) > 0:
                self.b0 = np.concatenate([self.b0, [DEFAULT_B0]])
        else:
            self.seen[job_id][:] = 0.0
            self.rounds[job_id] = 0
            if b0 is not None:
                b = np.asarray(self.b0, dtype=np.float64)
                if b.ndim == 0:
                    b = np.full(len(self.seen), float(b))
                b[job_id] = float(b0)
                self.b0 = b

    def state_dict(self) -> Dict[str, np.ndarray]:
        """Array state for crash-consistent checkpointing (rng state rides
        separately in the manifest's JSON half)."""
        return {
            "seen": np.stack(self.seen) if self.seen
            else np.zeros((0, self.num_classes)),
            "rounds": self.rounds.copy(),
            "b0": np.asarray(self.b0, dtype=np.float64),
        }

    def load_state_dict(self, state: Dict[str, np.ndarray]) -> None:
        seen = np.asarray(state["seen"], dtype=np.float64)
        if seen.shape[0] != len(self.seen):
            raise ValueError(
                f"checkpoint has {seen.shape[0]} jobs, runtime has "
                f"{len(self.seen)} — re-add jobs before loading")
        self.seen = [seen[i].copy() for i in range(seen.shape[0])]
        self.rounds = np.asarray(state["rounds"], dtype=np.int64).copy()
        b0 = np.asarray(state["b0"], dtype=np.float64)
        self.b0 = float(b0) if b0.ndim == 0 else b0.copy()

    def run_round(self, job_id: int, device_ids: np.ndarray, round_idx: int):
        hit = self.device_classes[np.asarray(device_ids)].ravel()
        np.add.at(self.seen[job_id], hit, 1.0)
        self.rounds[job_id] += 1
        # Coverage = 1 - TV(seen-class distribution, uniform): schedulers that
        # starve devices starve their classes and cap below the uniform optimum.
        s = self.seen[job_id]
        p = s / max(s.sum(), 1e-9)
        tv = 0.5 * float(np.abs(p - 1.0 / self.num_classes).sum())
        cov = 1.0 - tv
        ceiling = self.base + (1 - self.base) * cov ** self.power
        r = float(self.rounds[job_id])
        b = np.asarray(self.b0, dtype=np.float64)
        b0 = float(b[job_id] if b.ndim else b)
        acc = ceiling * (1 - 1 / (b0 * r + 1.0))
        acc = float(np.clip(acc + self.rng.normal(0, self.noise), 0, 1))
        loss = float(-np.log(max(acc, 1e-3)))
        return {"loss": loss, "accuracy": acc}
