"""Batching and host-local data feeding.

``Batcher`` is a deterministic, restartable batch iterator (epoch and
cursor are part of its state, so a checkpoint resumes the pipeline
exactly). ``host_local_batches`` gives one host's slice of a global batch.
A copy of the reference's ``repro/data/pipeline.py`` (numpy only), so the
batches and their order are the reference's bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple

import numpy as np


@dataclasses.dataclass
class Batcher:
    x: np.ndarray
    y: np.ndarray
    batch_size: int
    seed: int = 0
    epoch: int = 0
    cursor: int = 0

    def __post_init__(self):
        self._order = self._perm(self.epoch)

    def _perm(self, epoch: int) -> np.ndarray:
        return np.random.default_rng(self.seed + epoch).permutation(
            len(self.x))

    def state(self) -> Dict[str, int]:
        return {"epoch": self.epoch, "cursor": self.cursor, "seed": self.seed}

    def restore(self, state: Dict[str, int]) -> None:
        self.epoch, self.cursor, self.seed = (state["epoch"], state["cursor"],
                                              state["seed"])
        self._order = self._perm(self.epoch)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        return self

    def __next__(self) -> Tuple[np.ndarray, np.ndarray]:
        if self.cursor + self.batch_size > len(self.x):
            self.epoch += 1
            self.cursor = 0
            self._order = self._perm(self.epoch)
        idx = self._order[self.cursor: self.cursor + self.batch_size]
        self.cursor += self.batch_size
        return self.x[idx], self.y[idx]


def host_local_batches(global_batch: np.ndarray, host_id: int,
                       num_hosts: int) -> np.ndarray:
    """Slice the per-host shard of a global batch along axis 0."""
    per_host = global_batch.shape[0] // num_hosts
    return global_batch[host_id * per_host: (host_id + 1) * per_host]
