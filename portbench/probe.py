"""The benchmark's own instrumentation at the runtime's boundary.

``RuntimeProbe`` stands between the engine and its real-FL runtime and
forwards every call. It logs each cohort the engine announces
(``begin_round``). At each demand (``run_round``) it sees whether the
runtime flushed: the runtime's queue of announced rounds (``_queued``) is
replaced by a new one when a flush takes it, and the replaced queue names
the rounds the flush trained. So it counts their samples, SGD steps and
products in the measured window, marks where each flush's work ends in
the device's stream, keeps, while asked to, each job's parameters before
and after its last rounds, and copies the trained parameters to the host
after each flush of the warm-up. ``check_flushed`` holds the count to the
engine's records: a round recorded but never seen flushed stops the run.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class JobGeometry:
    """One job's work per device and round, from its configuration."""

    width: int                # samples on each device (partition width)
    steps: int                # batches per epoch
    batch: int
    epochs: int
    train_flops: int          # per trained sample
    eval_flops: int           # per evaluated sample (forward)
    eval_samples: int

    @property
    def samples_per_device(self) -> int:
        return self.steps * self.batch * self.epochs

    @property
    def sgd_steps(self) -> int:
        return self.steps * self.epochs


@dataclasses.dataclass
class WindowCount:
    rounds: int = 0
    samples: int = 0
    sgd_steps: int = 0
    flops: float = 0.0
    # (end marker, samples) of each flush: the marker is what ``mark()``
    # returned once the flush's work was queued.
    flushes: list = dataclasses.field(default_factory=list)


class RuntimeProbe:
    KEEP_PAIRS = 2    # a job's last rounds whose before and after are kept

    def __init__(self, runtime, geometry: List[JobGeometry]):
        self._rt = runtime
        self.geometry = geometry
        self.launches: List[Tuple[int, int, np.ndarray]] = []
        self.trained = [0] * len(geometry)
        self.count = WindowCount()
        self.counting = False
        self.mark = None
        self.snapshotting = False
        self.keeping_pairs = False
        # job -> {rounds trained: params on the host}
        self.snapshots: Dict[int, Dict[int, object]] = {
            j: {} for j in range(len(geometry))}
        # job -> {round: (params before it, params after it)}, on the device
        self.pairs: Dict[int, Dict[int, tuple]] = {
            j: {} for j in range(len(geometry))}
        self.flushed: set = set()

    def __getattr__(self, name):
        return getattr(self._rt, name)

    def begin_round(self, job_id, device_ids, round_idx):
        ids = np.array(device_ids, dtype=np.int64)
        self.launches.append((int(job_id), int(round_idx), ids))
        return self._rt.begin_round(job_id, device_ids, round_idx)

    def run_round(self, job_id, device_ids, round_idx):
        queue = self._rt._queued
        before = {}
        if self.keeping_pairs:
            before = {int(j): self._rt.params_of(j)
                      for j in set(queue) | {job_id}}
        out = self._rt.run_round(job_id, device_ids, round_idx)
        if self._rt._queued is not queue:
            self._flushed({(int(j), int(r)): len(ids)
                           for j, (ids, r) in queue.items()}, before)
        return out

    def check_flushed(self, records) -> None:
        """Every recorded round was seen trained by a flush."""
        missed = [(r.job, r.round_idx) for r in records
                  if (r.job, r.round_idx) not in self.flushed]
        if missed:
            raise RuntimeError(f"rounds {missed[:5]} were recorded without "
                               "a flush the probe saw: the runtime's queue "
                               "works otherwise than the probe reads it")

    def _flushed(self, rounds: Dict[Tuple[int, int], int], before) -> None:
        self.flushed.update(rounds)
        if self.counting:
            self.count.flushes.append((self.mark(), sum(
                n * self.geometry[job].samples_per_device
                for (job, _), n in rounds.items())))
        for (job, rnd), n in sorted(rounds.items()):
            self.trained[job] += 1
            g = self.geometry[job]
            if self.counting:
                self.count.rounds += 1
                self.count.samples += n * g.samples_per_device
                self.count.sgd_steps += g.sgd_steps
                self.count.flops += (float(n) * g.samples_per_device
                                     * g.train_flops
                                     + float(g.eval_samples) * g.eval_flops)
            if job in before:
                pairs = self.pairs[job]
                pairs[rnd] = (before[job], self._rt.params_of(job))
                for k in sorted(pairs)[:-self.KEEP_PAIRS]:
                    del pairs[k]
            if self.snapshotting:
                snaps = self.snapshots[job]
                params = to_host(self._rt.params_of(job))
                snaps[self.trained[job]] = params
                for k in [k for k in snaps if 1 < k < self.trained[job]]:
                    del snaps[k]


def to_host(tree):
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_host(v) for v in tree]
    return tree.detach().to("cpu", copy=True)
