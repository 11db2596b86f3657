"""Built-in runtime factories for the experiment registry.

A runtime factory turns ``(spec, jobs, pool, device=..., **runtime_kwargs)``
into an object implementing the engine's ``JobRuntime`` protocol; ``device``
is where tensor work runs (``ExperimentSpec.build(device=...)``).

- ``synthetic`` — the closed-form convergence model (scheduler-plane studies,
  fast tests). Per-job ``convergence_rate`` from the spec's jobs becomes the
  runtime's per-job ``b0`` array. It does no tensor work and ignores
  ``device``.
- ``real_fl`` — the paper's testbed: real local SGD + FedAvg on synthetic
  prototype data partitioned IID or non-IID (§5), on ``device``. By default
  the fused multi-job ``FusedMultiRuntime``; the spec's ``train`` axis
  (``TrainSpec``) selects the unfused per-job ``FLJobRuntime`` baseline and
  carries the bucket/eval_every/robust knobs.
"""

from __future__ import annotations

import warnings
from typing import List

import numpy as np

from repro_torch.config.base import ArchFamily, JobConfig
from repro_torch.core.devices import DevicePool
from repro_torch.experiment.registry import register_runtime
from repro_torch.fl.runtime import (DEFAULT_B0, FLJobRuntime,
                                    FusedMultiRuntime, MultiRuntime,
                                    SyntheticRuntime, default_buckets)


@register_runtime("synthetic")
def synthetic_runtime(spec, jobs: List[JobConfig], pool: DevicePool, *,
                      seed: int = 0, num_classes: int = 10,
                      classes_per_device: int = None, device=None, **kwargs):
    if classes_per_device is None:
        classes_per_device = 2 if spec.non_iid else num_classes
    rates = [js.convergence_rate for js in spec.jobs]
    if any(r is not None for r in rates) and "b0" not in kwargs:
        kwargs["b0"] = np.array(
            [DEFAULT_B0 if r is None else float(r) for r in rates])
    return SyntheticRuntime(num_jobs=len(jobs), num_devices=pool.num_devices,
                            num_classes=num_classes,
                            classes_per_device=classes_per_device,
                            seed=seed, **kwargs)


@register_runtime("real_fl")
def real_fl_runtime(spec, jobs: List[JobConfig], pool: DevicePool, *,
                    samples_per_job: int = 8000, eval_samples: int = 800,
                    noise: float = 1.2, data_seed: int = 0,
                    init_seed: int = 0, classes_per_device: int = 2,
                    parts_per_class: int = 20, device="cuda"):
    from repro_torch.data.synthetic import make_classification_dataset
    from repro_torch.fl.partition import iid_partition, noniid_partition

    for job in jobs:
        if job.model.family != ArchFamily.CNN:
            raise NotImplementedError(
                f"real_fl trains only the paper's CNN zoo, as the reference's "
                f"does; {job.model.name!r} is a {job.model.family.value} "
                "language model")
    datasets = []
    for jid, job in enumerate(jobs):
        cfg = job.model
        x, y = make_classification_dataset(
            samples_per_job, cfg.input_shape, cfg.num_classes, noise=noise,
            seed=data_seed + jid)
        ex, ey = make_classification_dataset(
            eval_samples, cfg.input_shape, cfg.num_classes, noise=noise,
            seed=data_seed + 100 + jid)
        if spec.non_iid:
            part = noniid_partition(y, pool.num_devices,
                                    classes_per_device=classes_per_device,
                                    parts_per_class=parts_per_class,
                                    seed=data_seed + jid)
        else:
            part = iid_partition(y, pool.num_devices,
                                 samples_per_device=samples_per_job
                                 // pool.num_devices,
                                 seed=data_seed + jid)
        datasets.append((x, y, part, ex, ey))

    train = spec.train
    if train.fused:
        buckets = train.buckets
        if buckets is None:
            # The reference aligns its buckets with the engine's operating
            # points (the steady cohort and the over-provisioned
            # selection); the port keeps the same ladder so that the same
            # cohorts are accepted.
            K = pool.num_devices
            n_hot = spec.effective_n_sel()
            sched = min(K, max(n_hot, int(round(n_hot * spec.over_provision))))
            buckets = tuple(sorted(set(default_buckets(K)) | {n_hot, sched}))
        # One fused runtime over all jobs: the per-job init seeds match the
        # unfused path (seed=init_seed + job_id).
        fault_engine = None
        if train.robust:
            # The runtime re-draws corrupt masks from the SAME keyed
            # schedule as the engine — a second FaultEngine over the same
            # spec replays identically, so no state is shared.
            fspec = spec.effective_faults()
            if fspec is not None and not fspec.inert:
                from repro_torch.faults import FaultEngine

                fault_engine = FaultEngine(fspec, pool.num_devices)
        return FusedMultiRuntime(jobs, datasets, seed=init_seed,
                                 buckets=buckets,
                                 eval_every=train.eval_every,
                                 robust=train.robust,
                                 reject_mult=train.reject_mult,
                                 fault_engine=fault_engine, device=device)
    if train.robust:
        warnings.warn(
            "TrainSpec.robust requires the fused runtime; the unfused "
            "baseline aggregates without fault screening", RuntimeWarning)
    if train.buckets is not None or train.eval_every != 1:
        warnings.warn(
            "TrainSpec.buckets/eval_every only apply to the fused runtime; "
            "the unfused baseline has no cohort buckets and evaluates every "
            "round", RuntimeWarning)
    return MultiRuntime([
        FLJobRuntime(job, *ds, seed=init_seed + jid, device=device)
        for jid, (job, ds) in enumerate(zip(jobs, datasets))])
