"""``FaultEngine``: the replayable per-round fault schedule.

The engine realizes a ``FaultSpec`` as concrete per-round fault draws.
Every draw comes from a COUNTER-KEYED generator —
``np.random.default_rng([seed, purpose, job, round_idx])`` over the full
device axis — so the schedule is a pure function of (spec, job, round):

- order-independent: jobs launching in a different interleaving (service
  resume, engine refactors) see identical faults;
- multi-reader: the training runtime recomputes the exact corrupt mask
  the engine drew, with no plumbing between them;
- resume-safe: a restored run replays the same faults without having to
  persist any stream position.

The only MUTABLE state is the strike counter behind escalating
quarantine (a fold over realized failures) and it round-trips through
``state_dict``/``load_state_dict`` for checkpointing.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.faults.spec import FaultSpec

# Draw purposes (the second RNG key word). Distinct per fault class so the
# classes are independent of each other at equal (job, round).
_SALT_DOMAIN_ASSIGN = 0
_SALT_DROPOUT = 1
_SALT_CRASH = 2
_SALT_STRAGGLER = 3
_SALT_DOMAIN_OUTAGE = 4
_SALT_CORRUPT = 5


class FaultEngine:
    """Realizes a ``FaultSpec`` for a ``num_devices``-sized fleet."""

    def __init__(self, spec: FaultSpec, num_devices: int):
        self.spec = spec
        self.num_devices = int(num_devices)
        # Escalating-quarantine strike counts (consecutive transient
        # failures per device; reset on a completed round).
        self.strikes = np.zeros(self.num_devices, dtype=np.int64)
        if spec.num_domains > 0:
            rng = np.random.default_rng([int(spec.seed), _SALT_DOMAIN_ASSIGN])
            self.domain = rng.integers(spec.num_domains,
                                       size=self.num_devices)
        else:
            self.domain = None

    # ---- keyed draws (stateless, replayable) ----

    def _uniform(self, salt: int, job: int, round_idx: int,
                 n: int) -> np.ndarray:
        rng = np.random.default_rng(
            [int(self.spec.seed), int(salt), int(job), int(round_idx)])
        return rng.random(n)

    def straggler_multipliers(self, job: int, round_idx: int) -> np.ndarray:
        """(K,) multiplicative slowdown on realized compute times (1.0 for
        unaffected devices); None when the spec has no stragglers."""
        sp = self.spec
        if sp.straggler_rate <= 0.0:
            return None
        slow = self._uniform(_SALT_STRAGGLER, job, round_idx,
                             self.num_devices) < sp.straggler_rate
        return np.where(slow, sp.straggler_slowdown, 1.0)

    def failure_masks(self, job: int, round_idx: int
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(transient (K,), crash (K,), domain_out (K,)) bool masks for one
        round. ``domain_out`` marks correlated (whole-domain) outages —
        disjoint from ``transient`` so the engine can apply the outage
        duration instead of backoff escalation."""
        sp, K = self.spec, self.num_devices
        transient = (self._uniform(_SALT_DROPOUT, job, round_idx, K)
                     < sp.dropout_rate if sp.dropout_rate > 0.0
                     else np.zeros(K, dtype=bool))
        crash = (self._uniform(_SALT_CRASH, job, round_idx, K)
                 < sp.crash_rate if sp.crash_rate > 0.0
                 else np.zeros(K, dtype=bool))
        if self.domain is not None and sp.domain_outage_rate > 0.0:
            out = self._uniform(_SALT_DOMAIN_OUTAGE, job, round_idx,
                                sp.num_domains) < sp.domain_outage_rate
            domain_out = out[self.domain]
        else:
            domain_out = np.zeros(K, dtype=bool)
        transient &= ~domain_out  # outage semantics win for domain members
        return transient, crash, domain_out

    def corrupt_mask(self, job: int, round_idx: int,
                     device_ids: np.ndarray) -> np.ndarray:
        """(len(ids),) bool — which of these devices upload a corrupted
        model this round. Keyed over the FULL device axis, so the engine
        and the runtime agree regardless of which subset each asks about."""
        ids = np.asarray(device_ids)
        if self.spec.corrupt_rate <= 0.0 or ids.size == 0:
            return np.zeros(ids.shape, dtype=bool)
        u = self._uniform(_SALT_CORRUPT, job, round_idx, self.num_devices)
        return u[ids] < self.spec.corrupt_rate

    # ---- escalating quarantine (the stateful fold) ----

    def quarantine_durations(self, device_ids: np.ndarray) -> np.ndarray:
        """Register transient failures and return each device's quarantine:
        ``cooldown * backoff**(strikes-1)`` capped at ``max_cooldown``."""
        ids = np.asarray(device_ids)
        if ids.size == 0:
            return np.zeros(0)
        self.strikes[ids] += 1
        d = self.spec.cooldown * self.spec.backoff ** (
            self.strikes[ids] - 1.0)
        return np.minimum(d, self.spec.max_cooldown)

    def record_success(self, device_ids: np.ndarray) -> None:
        """A completed round resets the strike counter (readmission)."""
        ids = np.asarray(device_ids)
        if ids.size:
            self.strikes[ids] = 0

    # ---- persistence ----

    def state_dict(self) -> dict:
        return {"strikes": self.strikes.copy()}

    def load_state_dict(self, tree: dict) -> None:
        self.strikes = np.asarray(tree["strikes"], dtype=np.int64).copy()
