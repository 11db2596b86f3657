"""Heterogeneous device pool with the paper's shifted-exponential time model.

Formula 4:  P[t_m^k < t] = 1 - exp(-(mu_k / (tau_m D_k^m)) * (t - tau_m a_k D_k^m))
i.e. t_m^k = tau_m * a_k * D_k^m  +  Exp(scale = tau_m * D_k^m / mu_k)

- ``a_k``  — deterministic per-sample cost floor (inverse max capability)
- ``mu_k`` — fluctuation rate (larger mu -> less jitter)
- ``D_k^m`` — local dataset size of job m on device k
- ``tau_m`` — local epochs of job m
- Expected time:  E[t_m^k] = tau_m * D_k^m * (a_k + 1/mu_k).

Fleet-scale fast path: the per-job time-model coefficients are materialized
ONCE as a structure-of-arrays (``_base``/``_shift``/``_scale``, (M, K), plus
float32 mirrors for the scoring core) so a 100k-device pool constructs and
schedules without per-round Python loops or repeated elementwise rebuilds —
``expected_times`` is a cached lookup, ``sample_times_into`` draws a round
into a caller-owned buffer with zero fresh allocation, and the ``*_all``
variants produce all M jobs fused in one vectorized call.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass
class DevicePool:
    """K devices, their capabilities, per-job data sizes, and occupancy."""

    a: np.ndarray          # (K,) capability floor, seconds per (epoch * sample)
    mu: np.ndarray         # (K,) fluctuation rate
    data_sizes: np.ndarray  # (K, M) samples of job m on device k
    rng: np.random.Generator

    # Occupancy: device k is busy until time busy_until[k] (simulated seconds).
    busy_until: np.ndarray = None  # (K,)

    # Pool-level dtype for every time-valued hot-path buffer (busy_until,
    # the SoA coefficient arrays, the sampling scratch buffer). float64 by
    # default; a million-device pool drops to float32 to halve its resident
    # footprint — the scoring core consumes the float32/bf16 mirrors either
    # way, so plan costs are unchanged.
    time_dtype: np.dtype = np.float64

    def __post_init__(self):
        self.time_dtype = np.dtype(self.time_dtype)
        if self.busy_until is None:
            self.busy_until = np.zeros(self.num_devices, dtype=self.time_dtype)
        else:
            self.busy_until = np.asarray(self.busy_until, dtype=self.time_dtype)
        self._soa_src = None  # SoA caches build lazily (data_sizes may be rescaled)
        self._version = 0     # bumped on every invalidation (churn detection)

    # ---- constructors ----

    @classmethod
    def heterogeneous(
        cls,
        num_devices: int,
        num_jobs: int,
        seed: int = 0,
        a_range=(2e-4, 2e-3),
        mu_range=(1.0, 10.0),
        data_range=(200, 600),
        time_dtype=np.float64,
    ) -> "DevicePool":
        """Log-uniform capabilities — a 10x speed spread as in edge fleets."""
        rng = np.random.default_rng(seed)
        a = np.exp(rng.uniform(np.log(a_range[0]), np.log(a_range[1]), num_devices))
        mu = rng.uniform(*mu_range, num_devices)
        d = rng.integers(data_range[0], data_range[1], size=(num_devices, num_jobs))
        return cls(a=a, mu=mu, data_sizes=d.astype(np.float64), rng=rng,
                   time_dtype=time_dtype)

    @property
    def num_devices(self) -> int:
        return int(self.a.shape[0])

    @property
    def num_jobs(self) -> int:
        return int(self.data_sizes.shape[1])

    # ---- structure-of-arrays fast path ----

    def invalidate(self) -> None:
        """Drop the SoA caches (``_base``/``_shift``/``_scale`` and the
        per-(job, tau) ``_exp_cache``/``_shift_cache`` memo tables). Needed
        after IN-PLACE mutation of ``a``/``mu``/``data_sizes`` (replacing
        ``data_sizes`` wholesale is detected automatically). The churn
        mutators below (``set_capabilities``/``add_job``/``rejoin``) call
        this themselves — use them instead of raw attribute writes and the
        caches can never go stale."""
        self._soa_src = None
        self._version += 1

    @property
    def version(self) -> int:
        """Monotone cache-generation counter: bumped every time the time
        model mutates (coefficient churn, job admission). Consumers holding
        derived arrays (scheduler services, plan caches) compare versions
        instead of re-deriving per round."""
        return self._version

    # ---- churn mutators (the invalidation hooks) ----

    def set_capabilities(self, device_ids, a=None, mu=None) -> None:
        """Mutate per-device capability coefficients in place and drop every
        derived cache. This is the supported way to model capability churn
        (thermal throttling, a rejoining device on a different network):
        writing ``pool.a[...]`` directly leaves ``_exp_cache`` serving the
        pre-churn time model."""
        ids = np.asarray(device_ids)
        if a is not None:
            self.a[ids] = a
        if mu is not None:
            self.mu[ids] = mu
        self.invalidate()

    def add_job(self, data_sizes: Optional[np.ndarray] = None) -> int:
        """Append one job column to ``data_sizes`` (dynamic job admission);
        returns the new job index. ``data_sizes`` defaults to a fresh draw
        from the range of the existing columns."""
        K = self.num_devices
        if data_sizes is None:
            if self.num_jobs == 0:
                raise ValueError("add_job on a 0-job pool needs explicit "
                                 "data_sizes (no range to draw from)")
            lo, hi = float(self.data_sizes.min()), float(self.data_sizes.max())
            data_sizes = self.rng.uniform(lo, hi, K)
        col = np.asarray(data_sizes, dtype=np.float64).reshape(K, 1)
        self.data_sizes = np.concatenate([self.data_sizes, col], axis=1)
        self.invalidate()  # new array is auto-detected; bump version anyway
        return self.num_jobs - 1

    def set_job_data(self, job: int, data_sizes: np.ndarray) -> None:
        """Overwrite one job's data-size column (and invalidate)."""
        self.data_sizes[:, job] = np.asarray(data_sizes, dtype=np.float64)
        self.invalidate()

    def depart(self, device_ids) -> None:
        """Membership churn: device(s) leave the fleet until ``rejoin``
        (identical occupancy semantics to a permanent fault)."""
        self.fail(device_ids, until=np.inf)

    def rejoin(self, device_ids, a=None, mu=None) -> None:
        """Departed device(s) return, optionally with drifted capability
        coefficients (cache invalidation included)."""
        if a is not None or mu is not None:
            self.set_capabilities(device_ids, a=a, mu=mu)
        self.recover(device_ids)

    def _ensure_soa(self) -> None:
        """(Re)build the per-job coefficient arrays; invalidates automatically
        when ``data_sizes`` is replaced (e.g. PoolSpec job_weights rescaling)."""
        if self._soa_src is self.data_sizes:
            return
        d = self.data_sizes.T                         # (M, K)
        dt = self.time_dtype
        self._base = np.ascontiguousarray(
            (d * (self.a + 1.0 / self.mu)).astype(dt, copy=False))  # E[t]/tau
        self._shift = np.ascontiguousarray(
            (d * self.a).astype(dt, copy=False))                    # floor/tau
        self._scale = np.ascontiguousarray(
            (d / self.mu).astype(dt, copy=False))                   # Exp scale/tau
        self._base32 = self._base.astype(np.float32)  # scoring-core mirror
        self._base_bf16 = None                        # lazy 2-byte mirror
        self._exp_cache = {}                          # (job, tau) -> (K,) E[t]
        self._shift_cache = {}                        # (job, tau) -> (K,) tau*shift
        self._ebuf = np.empty(self.num_devices, dtype=dt)
        self._soa_src = self.data_sizes

    # ---- time model (Formula 4) ----

    def expected_times(self, job: int, tau: float) -> np.ndarray:
        """(K,) expected round time per device for job ``job`` (cached —
        treat as read-only)."""
        self._ensure_soa()
        key = (int(job), float(tau))
        out = self._exp_cache.get(key)
        if out is None:
            out = tau * self._base[job]
            self._exp_cache[key] = out
        return out

    def expected_times32(self, job: int, tau: float) -> np.ndarray:
        """float32 expected times for the device scoring backends."""
        self._ensure_soa()
        return np.float32(tau) * self._base32[job]

    def expected_times_bf16(self, job: int, tau: float) -> np.ndarray:
        """Expected times computed from the 2-byte (bf16) coefficient
        mirror (a ``torch.bfloat16`` tensor on the host: float32 rounded to
        nearest even, as ``ml_dtypes`` rounds it in the reference), upcast
        to float32 for arithmetic. Quarter the float64
        coefficients' footprint at ~0.4% relative error (bf16 keeps
        float32's exponent range, 8 mantissa bits) — the memory-bound
        choice for million-device fleets. Built lazily; rebuilt with the
        SoA on churn."""
        self._ensure_soa()
        if self._base_bf16 is None:
            self._base_bf16 = torch.from_numpy(self._base32).to(torch.bfloat16)
        return np.float32(tau) * self._base_bf16[job].float().numpy()

    def expected_times_all(self, taus: Sequence[float]) -> np.ndarray:
        """(M, K) expected times for every job fused in one call."""
        self._ensure_soa()
        return np.asarray(taus, dtype=self.time_dtype)[:, None] * self._base

    def sample_times(self, job: int, tau: float, size: Optional[int] = None) -> np.ndarray:
        """Sample realized times for all K devices (one round)."""
        self._ensure_soa()
        if size is not None:
            e = self.rng.exponential(1.0, size=(size, self.num_devices))
            return tau * self._shift[job] + e * (tau * self._scale[job])
        out = np.empty(self.num_devices, dtype=self.time_dtype)
        return self.sample_times_into(job, tau, out)

    def sample_times_into(self, job: int, tau: float, out: np.ndarray) -> np.ndarray:
        """Allocation-free round sampling into a caller-owned (K,) buffer."""
        self._ensure_soa()
        key = (int(job), float(tau))
        shift = self._shift_cache.get(key)
        if shift is None:
            shift = tau * self._shift[job]
            self._shift_cache[key] = shift
        self.rng.standard_exponential(out=self._ebuf, dtype=self._ebuf.dtype)
        np.multiply(self._ebuf, self._scale[job], out=out)
        out *= tau
        out += shift
        return out

    def sample_times_all(self, taus: Sequence[float]) -> np.ndarray:
        """(M, K) one realized round for every job, one fused RNG draw."""
        self._ensure_soa()
        t = np.asarray(taus, dtype=self.time_dtype)[:, None]
        e = self.rng.standard_exponential((self.num_jobs, self.num_devices),
                                          dtype=self.time_dtype)
        return t * self._shift + e * (t * self._scale)

    # ---- occupancy ----

    def available_mask(self, now: float) -> np.ndarray:
        """(K,) bool — devices free at simulated time ``now``."""
        return self.busy_until <= now + 1e-12

    def occupy(self, mask: np.ndarray, until: np.ndarray | float) -> None:
        """Mark masked devices busy until ``until`` (scalar or per-device)."""
        until = np.asarray(until, dtype=self.time_dtype)
        if until.ndim == 0:
            until = np.full(self.num_devices, until, dtype=self.time_dtype)
        self.busy_until = np.where(mask, np.maximum(self.busy_until, until), self.busy_until)

    def fail(self, device_ids, until: float = np.inf) -> None:
        """Fault injection: device(s) drop out until ``until`` (default forever)."""
        mask = np.zeros(self.num_devices, dtype=bool)
        mask[np.asarray(device_ids)] = True
        self.occupy(mask, until)

    def recover(self, device_ids) -> None:
        self.busy_until[np.asarray(device_ids)] = 0.0

    # ---- persistence (crash-consistent service checkpoints) ----

    def state_dict(self) -> dict:
        """Array state for checkpointing. ``rng`` state is NOT included —
        PCG64 state holds 128-bit integers that don't fit numpy arrays, so
        it rides in the manifest's JSON half (``rng.bit_generator.state``)."""
        return {
            "a": self.a.copy(),
            "mu": self.mu.copy(),
            "data_sizes": self.data_sizes.copy(),
            "busy_until": self.busy_until.copy(),
        }

    def load_state_dict(self, state: dict) -> None:
        """Restore array state (shapes must match — re-add job columns via
        ``add_job`` first when resuming a run with dynamic admission)."""
        if np.shape(state["data_sizes"]) != self.data_sizes.shape:
            raise ValueError(
                f"checkpoint data_sizes {np.shape(state['data_sizes'])} vs "
                f"pool {self.data_sizes.shape} — re-add jobs before loading")
        self.a = np.asarray(state["a"], dtype=np.float64).copy()
        self.mu = np.asarray(state["mu"], dtype=np.float64).copy()
        self.data_sizes = np.asarray(state["data_sizes"],
                                     dtype=np.float64).copy()
        self.busy_until = np.asarray(state["busy_until"],
                                     dtype=self.time_dtype).copy()
        self.invalidate()
