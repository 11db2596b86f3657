"""Job runtimes: what happens when a round's devices "train".

``SyntheticRuntime`` — closed-form convergence model for scheduler-only
studies and fast tests: accuracy follows a saturating curve whose CEILING is
set by label coverage of the devices scheduled so far (non-IID: each device
holds 2 of C classes, so starving devices starves classes — the mechanism the
paper's fairness term addresses) and whose RATE follows Formula 13.

The training runtimes (``FusedMultiRuntime``, ``FLJobRuntime``,
``MultiRuntime``) are ROADMAP module 6.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


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
