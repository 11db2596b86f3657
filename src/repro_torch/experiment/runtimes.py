"""Built-in runtime factories for the experiment registry.

A runtime factory turns ``(spec, jobs, pool, **runtime_kwargs)`` into an
object implementing the engine's ``JobRuntime`` protocol.

- ``synthetic`` — the closed-form convergence model (scheduler-plane studies,
  fast tests). Per-job ``convergence_rate`` from the spec's jobs becomes the
  runtime's per-job ``b0`` array.
- ``real_fl`` — real local SGD + FedAvg; ROADMAP module 6, so its factory
  raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.config.base import JobConfig
from repro_torch.core.devices import DevicePool
from repro_torch.experiment.registry import register_runtime
from repro_torch.fl.runtime import DEFAULT_B0, SyntheticRuntime


@register_runtime("synthetic")
def synthetic_runtime(spec, jobs: List[JobConfig], pool: DevicePool, *,
                      seed: int = 0, num_classes: int = 10,
                      classes_per_device: int = None, **kwargs):
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
def real_fl_runtime(spec, jobs: List[JobConfig], pool: DevicePool, **kwargs):
    raise NotImplementedError(
        "runtime 'real_fl' (training on the CNN zoo, fl/runtime.py) is "
        "ROADMAP module 6, not ported yet")
